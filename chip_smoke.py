#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU.

Phases, each of which raises on failure:

1. build    - compile the CUDA sources of ``src/repro_torch/csrc`` (one
              ``nvcc`` per source, started together) and print the card.
2. kernels  - every kernel against its plain PyTorch version on the card,
              at the shapes of the serving path of internlm2-1.8b: K x N
              of each packed weight, M = 8 (decode) and M = 1024 (prefill
              of 8 x 128 tokens; the unembedding only at M = 8), both
              packings, both domains, plus untimed ragged shapes in f32,
              bf16 and int8 on both sides of M = 8.  Int8 must match
              bitwise, float within 1e-4 of max|y| (summation order only),
              and a second float call at M = 8 bitwise equal to the first
              (the gemv route's cluster adds its splits in rank order).
              The same cases, base3 only, at the other dense models'
              widest weights: glm4-9b's w1 (4096 x 13696) and w2 (13696 x
              4096) and qwen3-14b's w1 (5120 x 17408) and w2 (17408 x
              5120), at M = 8 and 1024; at M = 1024 the float route's
              error against an f64 sum is recorded beside the plain
              version's and that of one unsplit accumulator chain, and
              must stay within 1e-5 of max|y|.  And mixtral-8x7b's expert
              weights, w1 (4096 x 14336) and w2 (14336 x 4096), at the
              bucket's expert rows: M = 2 (decode) and M = 320 (prefill).
              And the recurrent models' new shapes at M = 8 and 1024:
              zamba2-7b's Mamba2 in_proj (3584 x 14576, a partial last
              column tile) and out_proj (7168 x 3584), and xlstm-125m's
              wif (1536 x 8).  And the cross-attending models' widest
              weights: whisper-large-v3's w1 (1280 x 5120, base3) at M =
              8 and M = 1500 (one request's frames), llama-3.2-vision-
              90b's w1 (8192 x 28672) and w2 (28672 x 8192) in trit2 at
              M = 8 and 1024 (K = 28672 splits the float mma chain).
              Each case names the route it took (``ROUTES``: bf16 and int8
              take ``gemv`` at M <= 8 and ``mma`` above, f32 takes
              ``cuda_core``) and prints the kernel's median device time
              (CUDA events behind a spin kernel, L2 flushed between
              launches), its bound, the achieved GB/s and the bound's
              share of the time, the plain version's time and a library
              call's time (a yardstick the port never calls).  At M = 8 it
              records gemv_plan's (block_n, cluster, k_per_split) and, from
              one call under torch.profiler after a flush, the kernel's own
              device time, checking that the call launched exactly one
              kernel, tm_gemv_kernel (no split-K reduce); at M =
              1024 it records mma_plan's (block_m, splits, k_per_split)
              (the autotune phase races the other plans).  Then
              per packing and domain the sums over one decode step and
              one prefill, beside the harness's floor: the same timing of
              a one-element add, times the number of matmuls.
3. paged-kernel - the paged_attention kernel against its plain version:
              untimed ragged cases (positions on page edges and 0, slots
              sharing a page, a null page full of garbage, hd 64 with 4
              grouped queries, pages of 5 at hd 40, hd 20 whose rows of
              40 bytes take the plain-loads route, glm4-9b's 2 KV x 16
              grouping, phi3-mini-3.8b's 32 KV x 1 at hd 96, qwen3-14b's
              8 KV x 5, and the front-end pools' geometry for
              internlm2-1.8b and qwen3-14b: 4 slots, 16 windows of 16,
              plan splits 8, per_rank 2, stages 2), each printed with its
              plan and taken through its load route (``ROUTES``: tma or
              loads), a second call bitwise equal to the first, and live
              slots bitwise unchanged with the null page zeroed.  Then
              three timed cases on realistic data: the serve shape (8
              slots, 8 KV heads x 2 grouped queries, hd 128, pages of 16,
              32 windows, bf16, a pool of 257 pages in random order),
              capacity 2048 (128 windows, a pool of 1025 pages),
              glm4-9b's grouping (2 KV x 16), phi3-mini-3.8b's (32 KV x 1,
              hd 96) and capacity 4096 (256 windows).  m within
              1e-5 * max(1, |m|), acc and l within 1e-4 of their per-row
              maximum.  Per timed case: paged_plan's launch shape, the
              load route, the time per call by CUDA events and the
              profiled device time (median of 3 calls after an L2 flush,
              each one kernel, paged_attention_kernel), beside the bound
              (live context and full table) and the plain version's time.
              ``--paged-only [--src DIR]`` builds and runs this phase
              alone, with the repro_torch package under DIR (another
              checkout's, to time its kernel on the same cases).
3b. autotune - the measured tile table (``kernels/autotune.py``) at full
              width: a --fast sweep of the main path's cells (internlm2-
              1.8b's five weights at M = 8 and 1024, both packings, both
              domains) into chiprun_out/autotune_fast.json, never the
              tracked table; every plan of that sweep and of the tracked
              table (which must cover the sweep on this card) run through
              its wrapper with ``tiles`` and held to the plain version:
              int8 bitwise, float within 1e-4 of max|y|, a float mma plan
              within 1e-5 of an f64 sum; the tracked main-path plans
              timed beside the rule's.  Then the base3 bucket runs of the
              serve phase in both domains, resolved from the tracked
              table (every plan ``block_source='autotune'``) and then
              with the table disabled (every plan ``'heuristic'``):
              prefill ms, ms per decode step, tokens; int8 tokens equal,
              float tokens equal or each first divergence a near tie.
              ``--autotune-only`` runs this phase alone.  Every later
              phase resolves its plans from the tracked table.
4. serve    - the bucket ServeEngine at full width (bf16, seeded random
              weights packed by ternarize_params; 8 requests of 128
              prompt tokens, 32 new tokens each) in the float and int8
              domains on base3 weights and the int8 domain on trit2
              weights.  The launch counts are zeroed just before each run
              and read just after: the run's kernel must have launched,
              its prefill through the mma route and its decode through
              gemv, with one host transfer per bucket and every token
              there.  Prints the prefill's and a decode step's wall time
              beside their kernels' summed device time, kernel count and
              the device's idle share (one prefill and one decode step
              under torch.profiler).
5. parity   - one prefill and four decode steps of the same model with
              the cuda backend and then the plain torch backend named
              explicitly: int8-domain logits bitwise equal, float-domain
              logits within 10% of the logit scale (24 bf16 layers carry
              the kernels' different summation order).
6. sched    - three continuous schedulers on one bursty trace at full
              width (base3 / float, 8 slots, chunk 8, capacity 512, pages
              of 16): the dense Scheduler, the PagedScheduler on the named
              gather path, and the PagedScheduler with fused_attn='auto',
              which must resolve the paged_attn kernel.  The counts are
              zeroed just before each run and read just after.  Checks:
              the fused run launched paged_attention once per layer per
              decode step run; gather tokens equal the dense ones; fused
              tokens equal the gather ones, or every first divergence is a
              near tie (top-2 logit margin <= 2% of the logit scale);
              host_transfers == chunks; resident paged KV peak <= half of
              the dense pool; prefix hit rate > 0.
6b. sanitize - the four engines at full width (bucket, dense, gather,
              fused; base3 / float) under ``repro_torch.analysis.
              sanitize``: each warmed on 8 requests, then serving 8 more
              of the same lengths with set_sync_debug_mode("error") on
              everywhere but the transfer chokepoint; one transfer per
              chunk (per bucket), no other sync, no new plan, no build.
6c. analysis - ``python -m repro_torch.analysis --device cuda`` in a
              process of its own: every pass clean, the capability pass
              executing the cuda cells, sanitize and frontend serving on
              the card.  ``--sanitize-only`` runs 6b and 6c alone.
7. long     - prompts past 2048 tokens on internlm2-1.8b at full width
              (base3, float domain), through the flash recurrence: one
              layer's flash_attention against the direct masked
              attention on the same q/k/v of 2560 positions in f32 (max
              difference within 1e-5 of max|v|); the bucket ServeEngine
              with 2 prompts of 6000 tokens (not a multiple of the
              512-position chunk) and 8 new tokens at capacity 6016 (one
              host transfer, 169 matmul launches a forward); the
              PagedScheduler, gather and fused, with one 3000-token
              request among 7 short ones at capacity 4096 (256 windows),
              held as the sched phase holds it.  Prints each long
              prefill's time.
8. fidelity - device-fidelity serving (``repro_torch.faults``) of
              internlm2-1.8b: the threefry kernel bitwise against its
              plain version on the card (and the CPU's for the small
              ones) on flat ranges from 0, past 2^31 and past 2^32, one
              layer's planes of the stacked w1 and the ADC noise's column
              runs; its time on that layer's planes beside its bound and
              the plain version's time.  One full-width w1 layer (2048 x
              8192, M = 8) of device_ternary_mac on the card and on the
              CPU under measured_fault_model(seed=0, drift_rate=0.001):
              bitwise with variation off; with variation on and ADC
              noise 0.5 (per_row, as the dense Scheduler calls it) at
              most 1% of the outputs differ.  Then, under that campaign,
              at full width and 8 of the 24 layers, the
              dense Scheduler and the fused PagedScheduler (4 requests x
              128 prompt tokens x 16 new, 2 slots, chunk 4, scrub_every
              2, capacity 256), each exact and then device: counts zeroed
              before each run and read after; one transfer per chunk, at
              least one scrub, the served trit error rate in (0, 3 x the
              restore bound], prefill on the mma route and no gemv in
              device decode (one gemv a prefill: its unembedding at
              M = 1), one fused read per layer per step; prints
              the power-on restore, disturb, probe, device decode step
              and exact prefill ms, the ADC clip counters and the greedy
              agreement with the exact run (not gated).
9. cim-kernel - cim_mac against its plain version (the macro model) on
              the card, bitwise, each call checked to take its route
              (ROUTES: ``codes`` at adc_bits >= 5, ``groups`` below):
              ragged cases (K % 16 != 0, M = 1, N off the tile, 3 x 5 and
              1 x 1 trit planes, adc_bits 3/4/5/8), all groups saturating
              (both entries at 5 bits), and planted saturating groups
              (x = -w in 5% of the (row, group) pairs) at adc_bits
              3/4/5/6/8 through the trit-plane entry and, at 5 and more,
              the code entry.  Then at every K x N of the model at M = 8
              and every one but the unembedding at M = 1024, random
              planes folded once into codes and a CodeWeight: the code
              entry's median time per call (the exact path's call), its
              product term alone, the trit-plane entry (fold included),
              its bound (one int8 product, 1 byte per weight) beside the
              groups route's 25-pair bound, the plain version's time, at
              M = 8 the groups route at b = 4 and at M = 1024
              torch._int_mm on the codes (the product alone, a yardstick).
10. exact   - macro-exact inference (CIMConfig(mode="exact")) through the
              bucket ServeEngine at full width on the bf16 float weights
              of the same seeded init: 8 requests of 128 prompt tokens, 16
              new tokens each, counts zeroed just before the run.  Checks:
              the engine resolved cuda; cim_mac launched 169 times per
              forward (1 prefill + the decode steps run), all on the codes
              route, and no ternary kernel did; each weight ternarized
              once (169 cache fills); one host transfer; every token
              there.  Then one prefill that fills the cleared weight
              cache, one that finds it, and four decode steps that fill
              nothing; one profiled decode step; then one prefill and two
              decode steps with the cuda backend and with the plain torch
              backend named: logits bitwise equal.  Prints the prefill
              times, the decode ms per step beside its encode (codes
              only), kernel and (0) ternarize device times and the cache's
              one-time fill, tok/s, and the greedy-token agreement with
              the float-mode model.
11. models  - glm4-9b, phi3-mini-3.8b and qwen3-14b, one at a time, each
              freed before the next, at full width (glm4-9b and
              qwen3-14b at 10 of their 40 layers, SERVE_LAYERS):
              seeded random bf16 weights on the card, packed to base3
              (a stacked weight one layer at a time), then the bucket
              ServeEngine on 8 requests x 128 prompt tokens x 16 new
              ones in the float domain, the counts zeroed just before
              the run: 7 matmuls a layer plus the unembedding launched
              per forward, prefill on the mma route and decode on gemv,
              one host transfer, every token there.  Prints the prefill
              ms, decode ms/step, tok/s, packed weight bytes and the
              decode bytes floor (those bytes at 3.35 TB/s).  Then the
              parity phase's check on the first 4 layers (every width
              kept) and, for glm4-9b, the PagedScheduler, gather and
              fused, on the first burst of the bursty trace (8
              requests), held as the sched phase holds it.

12. frontend - the serving front-end (``repro_torch.frontend``) over
              internlm2-1.8b and qwen3-14b at full width (qwen3 at 10
              of its 40 layers, SERVE_LAYERS; bf16
              float weights from seeded torch generators; paged pools of
              4 slots, chunk 4, capacity 256, pages of 16) behind one
              FrontendServer.  Eight records at t=0 (prompts of 96 and
              128 tokens, 16 and 24 new, cycled over both models), after
              a warm-up replay: the open-loop replay through the server
              (wall clock), counts zeroed just before and read after,
              then replay_direct on the same pools.  Checks: both pools'
              attention plan is paged_attn; per-request tokens equal;
              host_transfers == chunks; on_tokens sees every token once;
              paged_attention launched layers x decode steps per model
              (24 and 40 layers; each round's launches read around it)
              and no ternary kernel.  Then one profiled round per pool
              (wall ms, device busy ms, idle share); the same records
              into queue_limit=2 (pending <= 2, every submit accounted,
              queue-full rejects); and a 12-request overload trace (8
              batch requests at priority 1 with no deadline ahead of 4
              interactive ones at priority 0 with a deadline) under a
              VirtualClock ticking the parity replay's median round time,
              the deadline and the shedding floor fractions of the
              parity records' virtual makespan: SLOAdmission twice
              (identical admission logs) and FIFOAdmission, SLO goodput
              above FIFO's.  Last, the launcher's front-end mode on the
              card at full width (internlm2-1.8b, f32 as its registry's
              default): 8 x 128 tokens, 16 new, --admission slo,
              host_transfers == chunks in its JSON.
13. moe     - mixtral-8x7b (d_model 4096, 32/8 heads, 8 experts of
              d_ff 14336, top 2, window 4096, vocab 32000) at full width
              and 8 of its 32 layers: seeded random bf16 weights drawn
              and packed to base3 one layer at a time
              (``init_packed``; the 93 GB float tree never exists),
              printing the seconds and the peak device memory.  The
              bucket ServeEngine on 8 requests x 128 prompt tokens x 16
              new, counts zeroed just before the run: 32 x (4 + 3 x 8) +
              1 = 897 ternary_matmul launches a forward (one per expert
              and weight over the routing group's capacity rows),
              prefill on mma and decode on gemv, one transfer, every
              token there; one prefill's and one decode step's matmul
              shapes (experts at M = 320 and M = 2; w2's prefill K of
              14336 is split by the float chain cap); prefill ms, decode
              ms/step, tok/s, a profiled decode step (device ms, kernels,
              idle share) beside the bytes floor (every expert is read
              each step).  Expert parallelism's join on one card: layer
              0's MoE block with its experts in two halves, each half's
              products on every group's capacity rows, joined along E,
              bitwise the block at 8 x 128 and 8 x 1 rows.  Then the
              window run: the dense Scheduler, 2
              slots, chunk 8, capacity 4224 (the pool holds the window,
              4096 positions, and its bytes are checked), on a
              4160-token prompt (its prefill rolls) and a 4064-token one
              (its decode crosses position 4096), 64 new each: launches
              of a forward per prefill and per decode step launched, one
              transfer per chunk.  Last, on the first 4 layers of the
              same packed params (every width kept), the window run
              through the cuda backend ('auto' must resolve it) and the
              plain torch backend: tokens equal or a near tie at the
              first divergence, and the logits of each prompt's prefill
              and 63 decode steps (every routing call of both paths
              recorded) within 10% of the logit scale at every step
              whose routing choices agree in every layer; at a step
              where they differ, the first layer to differ may differ
              only at router near ties (the gap among a token's k + 1
              largest router logits <= 2% of its largest).
              ``--moe-only`` builds and runs this phase alone.
14. int8-kv - internlm2-1.8b at full width with an int8 KV cache
              (``kv_cache_dtype="int8"``, base3/float, the sched phase's
              weights): ``quantize_kv`` on one (24, 8, 512, 8, 128) bf16
              slab bitwise equal on the card and the CPU; the bucket
              engine on 8 x 128 + 32 at capacity 256 beside the float-KV
              run: prefill logits equal, one transfer, every token, the
              token agreement printed (not gated), decode ms/step of
              both; the dense Scheduler and the gather PagedScheduler on
              the bursty trace (gather tokens equal dense tokens, one
              transfer per chunk), fused_attn='auto' declining the fused
              read (no paged_attention launch, the gather's tokens) and
              fused_attn=True refused; the int8 dense pool exactly
              207,618,048 bytes against the float pool's 402,653,184.
              Runs after the sync-free chunk; ``--int8-kv-only`` runs it
              alone on its own draw of the weights.
15. recurrent - zamba2-7b (27 of its 81 Mamba2 layers: 4 shared-block
              invocations, a tail of 3) and xlstm-125m (6 mLSTM/sLSTM
              pairs, full depth) at full width, base3/float, one at a time:
              the default packing predicate's faults named (stacked norms
              of 81 layers; sLSTM's wr) and the launcher's xlstm-125m
              --packed base3 served (2 x 32 + 8: wr kept float, one
              transfer, every token); the weights drawn and
              packed a layer at a time (init_packed) through the model's
              pack_predicate; the bucket engine on 8 x 128 + 16,
              counts zeroed just before and read just after: 254 (zamba2)
              and 55 (xlstm) ternary_matmul launches a forward, prefill
              on mma (its unembedding at M = 8 on gemv) and decode on
              gemv, one transfer, every token; prefill ms, decode ms/step,
              tok/s, a profiled decode step (device ms, kernels, idle
              share) beside the decode floor (packed bytes plus the state
              read and written a step, at 3.35 TB/s); the dense Scheduler
              (4 slots, chunk 8, capacity 1024) on 7 prompts of 128 and
              one of 600 (zamba2's padded SSD chunks), 16 new each: the
              launches of every prefill and chunk step, one transfer per
              chunk, every token; the PagedScheduler refused with the
              reference's message; the cuda-vs-torch parity (prefill and
              4 decode steps, every step within 10% of the logit scale,
              the worst printed), zamba2 on its first 7 layers (one
              invocation, a tail of 1), xlstm at full depth.
              ``--recurrent-only`` runs these alone.
16. cross   - whisper-large-v3 (8 of its 32 encoder and 32 decoder
              layers, 1500 frames; base3/float) and llama-3.2-vision-90b
              (20 of its 100 layers: 4 gated cross blocks over 1601
              patches; trit2/float) at full width, one at a
              time, drawn and packed a layer at a time through
              pack_predicate (the VLM's default-predicate faults exactly
              blocks.ln1 and blocks.ln2); seeded N(0, 1) bf16 frames or
              patches, one tensor extra_inputs expands to the batch; the
              VLM's gates seeded nonzero (init's zeros hide the cross
              path).  The bucket engine (whisper 8 x 64 + 32 at capacity
              128, the VLM 8 x 128 + 16 at 144), counts zeroed just
              before and read just after: 513 / 781 ternary_matmul
              launches a prefill (mma but the unembedding) and 257 / 741
              a decode step (gemv), one transfer, every token; encoder,
              prefill and decode ms, tok/s, a profiled decode step
              beside the decode floor (the weights decode reads, the
              cross keys and values, 245,760,000 / 131,153,920 bytes a
              slot, and the self KV, at 3.35 TB/s); the VLM's prefill
              logits moving with other patches (> 1% of the scale); the
              dense Scheduler (4 slots, chunk 8, capacity 128 / 256, 6
              prompts): its launches, one transfer per chunk, every
              token; the PagedScheduler refused with the reference's
              message; the cuda-vs-torch parity (prefill and 4 decode
              steps within 10% of the logit scale) on the first 4
              encoder and decoder layers / the first 10 layers (2 cross
              blocks); then the launcher at full size, --packed base3 /
              trit2 on 2 x 32 + 8, one transfer.  ``--cross-only`` runs
              these alone.
17. train   - the training path (``repro_torch.train``): (a)
              internlm2-1.8b at full width and depth (24 layers, bf16,
              remat 'full'), AdamW with the launcher's warmup_cosine
              (peak 1e-3, warmup 5), 8 x 256 tokens a step from the
              port's data pipeline (its draws launch threefry, 6 a row),
              20 steps through make_train_step, after one batch's loss
              and grads computed twice and held bitwise equal; the
              counts zeroed just before the 20 steps and read just
              after (train_run, one row of TRAIN_RUNS).  Checks: every
              loss and grad norm finite, the mean of the last 5 losses
              below the first.  Prints the step ms (median, min, max of
              steps 2-20), tokens/s, the mfu share (6 x each matmul
              weight x the rows it multiplies over the step time at 989
              TFLOP/s), the bound (train_bound: the matmul operations of
              one step as it dispatches them, the backward and the remat
              re-forward included, at 989 TFLOP/s but for the products
              whose inputs the reference holds in f32, at 67; plus the
              optimizer's bytes at 3.35 TB/s), peak bytes, the idle
              share and top kernels of one step profiled with device
              activity only, and the threefry launches a step.  After
              the counted runs of (a), (b) and (d), each holds its data
              on the card to the CPU: the four 257-word draws of a row
              through threefry bitwise its plain version on the card and
              on the CPU, and a whole step's batch bitwise the CPU's.
              (b) The launcher at full width with Adafactor, 8 steps,
              into a temporary checkpoint directory removed after: its
              JSON line, the forced final save's bytes.  (c) Parity
              (train_parity): the full width cut to 2 layers, f32, one
              AdamW step on the card and on the CPU from the same params
              and 2 x 128 tokens, the optimizer's stacked leaves sliced
              (PARITY_PIECE): loss, grad norm and both moments within
              1e-4, the param updates within 1e-3 of lr but for at most
              1e-4 of the weights, all within 2 lr.  (d) Replay: the
              Trainer at smoke width (8 x 256 tokens of a 512-token
              chain) through crashes at steps 5 and 11 and in the save of
              step 12: params and optimizer state bitwise equal to an
              uninterrupted run's.  (e) Exact mode, 2 layers at full
              width in f32 on 2 x 128 tokens: loss and grads through the
              cuda code route (cim_mac launched 29 times: 15 matmuls
              forward, 14 in the re-forward) and through the torch route
              within 1e-6 of each tensor's max (bitwise printed), then
              one make_train_step step whose 'auto' backend launches
              cim_mac 29 times.  Its launches join cim_mac's row of the
              kernels line, and the threefry launches of (a), (b) and
              (d) join threefry's.  ``--train-only`` runs this phase
              alone.
18. train-families - the other four families trained, each a
              row of TRAIN_RUNS through the same train_run and
              train_parity as phase 17: xlstm-125m (AdamW, remat 'none',
              4 of its 12 layers, 4 steps) and whisper-large-v3 (AdamW,
              8 + 8 of its 32 + 32 layers, 6 steps), zamba2-7b
              (Adafactor, 27 of its 81 layers, 6 steps, peak lr 3e-4)
              and llama-3.2-vision-90b (10 of its 100 layers: two groups;
              Adafactor, 6 steps), with 8 x 1500 frames or 8 x 1601
              patches of bf16 normals drawn through threefry (49
              launches a step).  Checks: (a) every loss and grad norm
              finite (zamba2's gradients at 256 positions, where the
              reference's overflow), the mean of the last two losses
              below the first; (b) after the steps, the data of a step,
              frames or patches included, on the card bitwise the CPU's;
              (c) a cut of each (2 layers, whisper 2 + 2, the VLM one
              group of 2 self layers and its cross block, zamba2 one
              group of 6 and the shared block; every width kept), f32,
              one step of its own optimizer on 2 x 64 tokens, card
              against CPU as phase 17's (c); the VLM's peak under
              FAM_PEAK_LIMIT.  Prints what phase 17's (a) prints; then
              the VLM's 105 M-word patch draw: threefry against its
              plain version (bitwise, timed, bound) and the whole
              normal_bf16.  Its launches join threefry's row of the
              kernels line.  ``--train-families-only`` runs this phase
              alone.

19. mesh    - the sharding layer (``repro_torch.dist``) on a one-card
              ``DeviceMesh`` (1, 1) ("data", "model") over NCCL: the
              phase starts the process group and destroys it at the end.
              (a) the bucket engine, internlm2-1.8b base3/float at full
              width and depth, 8 x 128 prompt tokens + 32 new at capacity
              256, unmeshed and through ``ServeEngine(rules=serve rules,
              mesh=)``: the tokens, ``ternary_matmul``'s launches and
              routes equal, one host transfer per bucket; prefill ms and
              decode ms a step of both.  (b) 3 AdamW steps of the train
              phase's run (bf16, remat full, 8 x 256 tokens; full width,
              4 of its 24 layers) unmeshed and
              on the mesh (``make_train_step(rules=, mesh=)`` on placed
              state): losses and every param and moment bitwise equal;
              ms a step of both.  (c) a checkpoint of the meshed state
              after step 2, restored unmeshed and onto a fresh mesh
              (``restore(placements=)``): each goes on to step 3 bitwise
              equal to (b).  (d) the tensor-parallel route, which a
              one-card mesh does not split: base3 and trit2 weights at
              w1's (2048, 8192) cut in two along N, at w2's (8192, 2048)
              and at (2046, 2048) (trit2's last shard pads its input)
              cut along K; each shard through ``cim_linear.linear``'s
              planned kernel on its local shape (``ShardedPacked.
              partial``), the parts joined as the collective joins them,
              within MESH_TP_TOL of max|y| of the unsharded kernel, at
              M = 8 (gemv) and M = 1024 (mma), bf16 x; in the int8
              domain w2's and the (2046, 2048) weight's two K shards
              through the kernel's int32 epilogue
              (``ShardedPacked.partial_int32`` on x quantized over its
              whole row), added in int32, then the epilogue once:
              bitwise the unsplit ``ternary_matmul_int8``.  (e) The dense
              Scheduler and the PagedScheduler's gather read on the
              bursty trace's first SCHED_CUT requests, unmeshed and with
              ``rules=, mesh=`` (phase 5's runs and checks each): tokens,
              launches and routes equal, one transfer per chunk, ms a
              decode step of both; then both meshed schedulers under
              ``analysis.sanitize`` (one transfer per chunk, no other
              sync).  (f) The int8 bucket (base3, 8 x 128 + 8) and the
              exact bucket (float weights of the same seed, 8 x 32 + 4),
              unmeshed and meshed, after a warm-up bucket: tokens,
              launches and routes equal, the engine's own prefill and
              decode logits bitwise, no code-weight fill after the
              warm-up.  (g) Every family's training on the mesh
              (MESH_FAMILIES, full width, cut depth), each beside an
              unmeshed run from the same init and batches, losses and
              every param and optimizer-state leaf bitwise: internlm2-
              1.8b with Adafactor (3 steps, 4 layers), exact mode (2
              steps, 2 layers, f32; cim_mac on its codes route),
              mixtral-8x7b (one Adafactor step, 2 of 32 layers), and one
              step each of zamba2-7b (7 layers), xlstm-125m (4),
              whisper-large-v3 (4 + 4) and the VLM (one group of 5).
              The counts are zeroed just before the meshed runs of (a),
              (b), (e), (f) and (g) and read just after:
              ``ternary_matmul``, ``ternary_matmul_int8``, ``cim_mac``
              and ``threefry`` must have launched, ``paged_attention``
              not (the meshed pool reads through the gather); they join
              the kernels line as ``launches_mesh`` (and
              ``launches_mesh_sched``, ``cim_mac``'s
              ``launches_mesh_train``).  (The ``shard`` pass runs in
              phase 7's analysis CLI.)  ``--mesh-only`` runs this phase
              alone.
20. dryrun  - the dry run's roofline (``repro_torch.launch.dryrun``,
              ``repro_torch.roofline``) held to the card.  (a) Three cells
              of internlm2-1.8b at full width: the bucket's decode step
              (8 slots, capacity 256, base3/float), its prefill (8 x 128,
              base3/float) and an AdamW train step (8 x 256, bf16, remat
              full), each dry-run on a fake one-rank (1, 1) mesh, then
              run for real.  It fails where the predicted ternary-matmul
              calls or routes differ from ``LAUNCHES`` / ``ROUTES`` of the
              real call, where the train step's predicted bf16 and f32
              product operations differ from ``step_ops`` on the real
              step, where the predicted live-bytes peak is more than
              DRYRUN_PEAK_TOL off the real one (``max_memory_allocated``
              after ``reset_peak_memory_stats``, counted from the call's
              inputs), where the roofline time (the largest of its three
              terms) exceeds the profiled device busy time, and where the
              decode step's packed-matmul bytes differ from the packed
              weights the bytes floor reads.  Each cell prints busy /
              bound and the bounding term, beside ``train_bound`` and the
              decode bytes floor.  Beside them one chunk of the
              Scheduler (8 slots at capacity 512, 8 steps; ``--continuous``
              on the fake mesh, then a warm chunk on the card): its
              predicted calls and routes are the card's.  (b) The
              production cell through the CLI, ``python -m repro_torch.launch.dryrun --arch
              internlm2-1.8b --shape train_4k`` on the 16x16 fake mesh,
              in a subprocess started with (a) (it needs no card) into
              ``chiprun_out/dryrun_torch`` and read as the phase
              ``dryrun-cli``: exit 0 and a report with the reference's
              keys.  In a whole run (a) runs before the train phases;
              (b) starts after the build, niced on one thread, and is
              read after them, so the host traces while the card
              serves.  ``--dryrun-only`` runs this phase alone.

A whole run does the card-vs-CPU checks of phases 8 (the device-MAC
layer) and 17-18 (train_parity) in a parity worker, a process of its own
started after the build (``--parity-worker``): it runs every card part
while the main process runs phase 7's analysis CLI (``parity-card``
waits for it), then the CPU parts on 5 of the host's cores, niced, while
the main process goes on with the card; ``parity-cpu`` reads its records
at the end.  Phase 20's CLI cell traces beside the whole run as well.
Each phase prints its seconds, torch.cuda.max_memory_allocated() and the
bytes still allocated when it began (after a gc.collect()).
The last two lines are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py
    python3 chip_smoke.py --paged-only [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --moe-only
    python3 chip_smoke.py --int8-kv-only --recurrent-only
    python3 chip_smoke.py --cross-only
    python3 chip_smoke.py --train-only
    python3 chip_smoke.py --train-families-only
    python3 chip_smoke.py --autotune-only --sanitize-only
    python3 chip_smoke.py --mesh-only
    python3 chip_smoke.py --dryrun-only
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_IMPORT = time.monotonic()
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, data sheet
PEAK_OPS_PER_S = {"float": 989e12,         # bf16 tensor cores, dense
                  "int8": 1979e12}         # int8 tensor cores, dense
PEAK_F32_OPS_PER_S = 67e12               # f32 outside the tensor cores
ARCH = "internlm2-1.8b"
# kernel cases at the other dense models' widest weights: (arch, weight,
# K, N); glm4-9b's d_ff 13696 = 107 x 128 is both N and K
OTHER_MODEL_SHAPES = [("glm4-9b", "w1,w3", 4096, 13696),
                      ("glm4-9b", "w2", 13696, 4096),
                      ("qwen3-14b", "w1,w3", 5120, 17408),
                      ("qwen3-14b", "w2", 17408, 5120)]
BATCH, PROMPT, MAX_NEW, CAPACITY = 8, 128, 32, 256
# paged serving: slots, chunk, per-request capacity, page size
SLOTS, CHUNK, SCHED_CAPACITY, PAGE = 8, 8, 512, 16
NEAR_TIE = 0.02               # fused vs gather: top-2 margin / logit scale
AUTOTUNE_STEPS = 8            # decode steps timed per autotune bucket run
FLOAT_TOL = 1e-4              # kernel vs plain, relative to max|y|
CHAIN_TOL = 1e-5              # float mma route vs an f64 sum, the same
                              # (the card tests' bar for one matmul)
MODEL_FLOAT_TOL = 0.1         # logits, relative to max|logit|
SPIN_CYCLES = 2_000_000       # ~1 ms at the H100's 1.98 GHz clock
EXACT_NEW = 16               # new tokens per request in the exact phase
# the depth the other models serve at, each at full width: the script's
# time limit cuts depth first (internlm2-1.8b, the main path, phi3-mini
# and xlstm-125m keep theirs); whisper cuts its encoder alike
SERVE_LAYERS = {"glm4-9b": 10, "qwen3-14b": 10, "mixtral-8x7b": 8,
                "zamba2-7b": 27, "whisper-large-v3": 8,
                "llama-3.2-vision-90b": 20}
# the models phase: the other dense models at full width
MODEL_ARCHS = ("glm4-9b", "phi3-mini-3.8b", "qwen3-14b")
MODELS_NEW = 16              # new tokens per request
PARITY_LAYERS = 4            # depth of the models' cuda-vs-torch check
SCHED_ARCH = "glm4-9b"       # served through the PagedScheduler as well
SCHED_CUT = 8                # requests of the bursty trace it serves
# the long phase (internlm2-1.8b): the bucket engine at 2 x 6000 prompt
# tokens, the PagedScheduler with one 3000-token request at capacity 4096,
# and one layer's flash recurrence held to the direct attention
LONG_BATCH, LONG_PROMPT, LONG_NEW, LONG_CAPACITY = 2, 6000, 8, 6016
SCHED_LONG_PROMPT, SCHED_LONG_CAPACITY = 3000, 4096
FLASH_CHECK_T = 2560
FLASH_TOL = 1e-5             # flash vs direct in f32, relative to max|v|
# the fidelity phase (internlm2-1.8b, base3/float, the launcher's campaign)
FID_REQUESTS, FID_NEW, FID_SLOTS, FID_CHUNK = 4, 16, 2, 4
FID_SCRUB_EVERY, FID_CAPACITY, FID_PAGE = 2, 256, 16
FID_LAYERS = 8               # the served depth, of 24: the plain device MAC
                             # takes ~0.75 s a decode step at 24
FID_VAR_SHARE = 0.01         # device MAC with variation: outputs that may
                             # differ between card and CPU (f32 counts
                             # summed in another order)
# the frontend phase: the reference's two front-end models at full width
# and depth (bf16), one paged pool each behind one FrontendServer
FE_MODELS = ("internlm2-1.8b", "qwen3-14b")
FE_SLOTS, FE_CHUNK, FE_CAPACITY, FE_PAGE = 4, 4, 256, 16
FE_REQUESTS = 8              # parity records, all at t=0, cycled over
FE_PROMPTS = [96, 128, 128, 96]          # both models
FE_NEWS = [16, 24, 24, 16]
# the overload trace: 12 requests, the batch class (priority 1, no
# deadline) ahead of the interactive class (priority 0, a deadline) in
# arrival order; (prompt, max_new) of each class
FE_OVERLOAD, FE_INTERACTIVE = 12, 4
FE_BATCH, FE_INTER = (128, 24), (96, 8)
FE_TIGHT, FE_FLOOR = 0.6, 0.1  # deadline, shedding floor: x the parity
                               # records' virtual makespan
FE_LAUNCHER_ARGS = ["--frontend", "--requests", "8", "--prompt-len", "128",
                    "--max-new", "16", "--admission", "slo",
                    "--deadline-s", "30"]
# the moe phase: mixtral-8x7b at full width (SERVE_LAYERS), base3, drawn and
# packed one layer at a time; kernel cases at its expert weights, at the
# bucket's decode M (8 rows, one group: capacity 2; the window run's 2
# slots, a group each of capacity 1, make M = 2 as well), its prefill M
# (8 x 128 tokens, one group: capacity 320) and the window run's prefill
# M (4064 and 4160 tokens: 4 and 5 groups of 1024 at capacity 320)
MOE_ARCH = "mixtral-8x7b"
MOE_SHAPES = [("mixtral-8x7b", "w1,w3 expert", 4096, 14336),
              ("mixtral-8x7b", "w2 expert", 14336, 4096)]
MOE_MS = (2, 320, 1280, 1600)
MOE_NEW = 16                 # new tokens per request in the bucket run
# the window run: the dense Scheduler past mixtral's window of 4096 (a
# prompt longer than it, one decoding across it) at a capacity above it
WIN_SLOTS, WIN_CHUNK, WIN_CAPACITY, WIN_NEW = 2, 8, 4224, 64
WIN_PROMPTS = (4160, 4064)
# the recurrent phase: zamba2-7b and xlstm-125m at full width and
# depth, base3/float; the bucket engine on 8 x PROMPT + REC_NEW, the dense
# Scheduler on 7 prompts of 128 and one of 600 (past the SSD chunk of
# 256 and not a multiple of it), REC_NEW new each; kernel cases at
# zamba2's Mamba2 projections (N = 14576 is 113.875 column tiles of 128)
# and xlstm's wif (N = 8, packed on every call)
REC_ARCHS = ("zamba2-7b", "xlstm-125m")
REC_NEW = 16
REC_SLOTS, REC_CHUNK, REC_CAPACITY = 4, 8, 1024
REC_PROMPTS = [128] * 7 + [600]
ZAMBA_PARITY_LAYERS = 7      # one shared-block invocation, a tail of 1
RECURRENT_SHAPES = [("zamba2-7b", "mamba in_proj", 3584, 14576),
                    ("zamba2-7b", "mamba out_proj", 7168, 3584),
                    ("xlstm-125m", "mlstm wif", 1536, 8)]
# the cross phase: whisper-large-v3 (base3) and llama-3.2-vision-90b
# (trit2) at full width (SERVE_LAYERS); the bucket engine on
# 8 x prompt + new, the dense Scheduler on 6 prompts; the cut parity's
# layers; the matmuls of one prefill and one decode step (asserted
# against cross_forward_matmuls) and the cross keys and values a slot
CROSS_ARCHS = ("whisper-large-v3", "llama-3.2-vision-90b")
CROSS_SLOTS, CROSS_CHUNK = 4, 8
CROSS = {
    "whisper-large-v3": dict(
        packing="base3", prompt=64, new=32, capacity=128,
        sched_capacity=128, sched_prompts=[64, 40, 64, 24, 80, 48],
        parity_layers=4, faults=[], per_prefill=129, per_step=65,
        cross_slot=61_440_000),
    "llama-3.2-vision-90b": dict(
        packing="trit2", prompt=128, new=16, capacity=144,
        sched_capacity=256, sched_prompts=[128, 96, 200, 128, 64, 160],
        parity_layers=10, faults=["blocks.ln1", "blocks.ln2"],
        per_prefill=157, per_step=149, cross_slot=26_230_784)}
# kernel cases at their widest weights: (arch, weight, K, N, packing, Ms)
CROSS_SHAPES = [("whisper-large-v3", "w1", 1280, 5120, "base3", (8, 1500)),
                ("llama-3.2-vision-90b", "w1,w3", 8192, 28672, "trit2",
                 (8, 1024)),
                ("llama-3.2-vision-90b", "w2", 28672, 8192, "trit2",
                 (8, 1024))]
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # H100 SXM: 64 INT32 lanes an SM
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_BATCH, TRAIN_SEQ = 8, 256    # the reference launcher's defaults
TRAIN_LR = 1e-3                    # the launcher's default peak lr
TRAIN_LAUNCHER_STEPS = 8
TRAIN_PARITY_LAYERS = 2            # exact mode's cut
TRAIN_PARITY_BATCH = (2, 128)      # rows x positions of exact mode's steps
TRAIN_PARITY_TOL = 1e-4            # loss, grad norm, moments (relative)
PARITY_PIECE = 1 << 20             # optimizers.PIECE in the parity steps
TRAIN_REPLAY = dict(total=16, interval=4, crash_at=(5, 11),
                    crash_in_save=(12,))
# the training runs, each at full width from model.init on the card,
# bf16, remat from the config, the launcher's warmup_cosine(lr, max(steps
# // 20, 5), steps) at peak ``lr`` (TRAIN_LR by default), TRAIN_BATCH x
# TRAIN_SEQ tokens a step from batch_for: ``layers`` cuts the depth (the
# VLM: two groups of 5 self layers and their cross block, of 100 layers;
# whisper its encoder alike),
# the mean of the last ``fall`` losses must be below the first, ``twice``
# holds one batch's loss and grads bitwise over two runs, ``parity`` is
# the rows x positions of the cut's card-vs-CPU step (train_parity) and
# ``share`` the most of its weights whose updates may differ by more than
# 1e-3 lr (1e-3 by default, as tests/test_torch_cuda.py holds the
# families' smoke steps; whisper's cut has 1.13e-4 of them at 2 x 64).
# TRAIN_ARCH is the train phase's; the others the train-families phase's.
# zamba2 trains at a peak lr of 3e-4: at the launcher's 1e-3 its loss rose
# after the step-4 update at lr 8e-4 (10.89 ... 9.59, then 12.22), as the
# reference's does at one group of its full width
# (tests/adafactor_lr_witness.py; PERF.md)
TRAIN_RUNS = {
    TRAIN_ARCH: dict(optimizer="adamw", steps=20, fall=5, twice=True,
                     parity=(2, 128), share=1e-4),
    "xlstm-125m": dict(layers=4, optimizer="adamw", steps=4, fall=2,
                       parity=(2, 64)),
    "whisper-large-v3": dict(layers=8, optimizer="adamw", steps=6, fall=2,
                             parity=(2, 64)),
    "zamba2-7b": dict(layers=27, optimizer="adafactor", steps=6, fall=2,
                      lr=3e-4, parity=(2, 64)),
    "llama-3.2-vision-90b": dict(layers=10, optimizer="adafactor", steps=6,
                                 fall=2, parity=(2, 64))}
VLM_ARCH = "llama-3.2-vision-90b"
FAM_PEAK_LIMIT = 70e9        # the VLM's peak bytes at two groups
FAM_DRAW = (8, 1601, 8192)   # the VLM's patches, a step's largest draw
THREEFRY_REPLACES = "src/repro/faults/scrub.py:85"
KERNEL_NAMES = {"float": "ternary_matmul", "int8": "ternary_matmul_int8"}
REPLACES = {"float": "src/repro/kernels/ternary_matmul.py:144",
            "int8": "src/repro/kernels/ternary_matmul.py:202"}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def layer_shapes(cfg):
    """(name, K, N, matmuls per forward) of every packed weight."""
    d, hd = cfg.d_model, cfg.hd
    L = cfg.num_layers
    return [("wq,wo", d, cfg.num_heads * hd, 2 * L),
            ("wk,wv", d, cfg.num_kv_heads * hd, 2 * L),
            ("w1,w3", d, cfg.d_ff, 2 * L),
            ("w2", cfg.d_ff, d, L),
            ("unembed", d, cfg.padded_vocab, 1)]


def bound(moved_bytes, ops, domain):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for the type."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[domain] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def rate(rec):
    """Achieved GB/s (the bytes the call must move over its time) and
    the bound's share of the time."""
    return dict(gbps=rec["bytes"] / rec["ms"] / 1e6,
                bound_share=rec["bound_ms"] / rec["ms"])


def time_ms(torch, fn, reps, flush):
    """Median device ms of `fn` over `reps` launches, each timed by CUDA
    events with the L2 cache flushed before it (the serving path reads
    every weight cold).  A spin kernel queued ahead of the start event
    keeps the card busy while the host enqueues `fn`, so the events time
    the device's work and not the host's launch cost, which varies from
    machine to machine."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy(torch, fn, tries=5):
    """(summed kernel device ms, kernels launched, their names) of one
    call of `fn` under torch.profiler (``device_kernels``)."""
    per = device_kernels(torch, fn, tries)
    return (sum(ms for ms, _ in per.values()),
            sum(n for _, n in per.values()), sorted(per))


def device_kernels(torch, fn, tries=5, host=True):
    """{kernel name: (device ms, launches)} of one call of `fn` under
    torch.profiler (``host=False``: device activity only, for a call of
    ~10^5 kernels, whose host ops would take minutes to record and
    average).  Each capture ends with a marker
    (a short spin kernel, which `fn` never launches) after `fn`'s work
    has finished; the marker is left out of the result.  Now and then
    CUPTI hands over no device record of a whole session, the marker's
    included, so a capture without its marker is taken again, up to
    `tries` times, and one that never shows it is an error."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        # the raw device records (kernels, copies, fills) summed by name
        # here: key_averages() takes seconds for each 10^4 of them
        per, marker = {}, False
        for e in prof.profiler.kineto_results.events():
            if (e.device_type() != torch.autograd.DeviceType.CUDA
                    or e.is_user_annotation()):
                continue
            if "spin_kernel" in e.name():
                marker = True
                continue
            ms, n = per.get(e.name(), (0.0, 0))
            per[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
        if marker:
            return per
    raise SmokeError(f"the profiler recorded no marker in {tries} captures")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    build.build_all(verbose=True)
    print(f"[build] {len(build.SOURCES)} source(s) in "
          f"{time.monotonic() - t0:.1f} s")
    for src, info in build.BUILD_INFO.items():
        for line in info.get("log", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def routed(tm, fn):
    """fn()'s result and the route it took (``ROUTES`` before and
    after: one name, or the list of every route that moved)."""
    before = dict(tm.ROUTES)
    out = fn()
    path = [r for r in tm.ROUTES if tm.ROUTES[r] != before[r]]
    return out, path[0] if len(path) == 1 else path


def expected_route(torch, m, dtype):
    if dtype == torch.float32:
        return "cuda_core"
    return "gemv" if m <= 8 else "mma"


def phase_kernels(torch, cfg):
    """Kernel vs plain version at the path's shapes; returns per-case
    records."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_matmul as tm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    for mode in ("base3", "trit2"):            # ragged edges, untimed
        for m, k, n in ((1, 64, 5), (3, 520, 130), (8, 200, 2050),
                        (5, 2112, 2064), (13, 200, 136), (17, 64, 5),
                        (129, 520, 130), (300, 200, 136)):
            kw = k if mode == "base3" else k // 4
            data = torch.randint(0, 256 if mode == "trit2" else 243, (kw, n),
                                 generator=gen, device=dev, dtype=torch.uint8)
            scale = torch.rand(n, generator=gen, device=dev)
            w = ops.PackedTernary(data, scale, mode)
            x = torch.randn(m, k, generator=gen, device=dev)
            for xf in (x, x.to(torch.bfloat16)):
                want = ops.ternary_matmul_torch(xf, w)
                got, path = routed(tm, lambda: tm.matmul_float(
                    xf, data, scale, mode))
                err = (got - want).abs().max()
                check(err.item() <= FLOAT_TOL * want.abs().max().item(),
                      f"ternary_matmul {mode} {xf.dtype} {(m, k, n)}: "
                      f"error {err.item()}")
                check(path == expected_route(torch, m, xf.dtype),
                      f"ternary_matmul {xf.dtype} at M={m} took {path}")
            xi, xs = ops.quantize_acts_int8(x)
            got, path = routed(tm, lambda: tm.matmul_int8(
                xi, xs, data, scale, mode))
            check(torch.equal(got, ops.ternary_matmul_int8_torch(xi, xs, w)),
                  f"ternary_matmul_int8 {mode} {(m, k, n)} is not bitwise")
            check(path == expected_route(torch, m, xi.dtype),
                  f"ternary_matmul_int8 at M={m} took {path}")
    print("[kernels] ragged shapes agree, each through its route")
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(torch, lambda: one.add_(1), 50, flush)
    print("[kernels] " + json.dumps(dict(harness_floor_ms=floor_ms)))
    cases = []
    for mode in ("base3", "trit2"):
        for name, k, n, per_forward in layer_shapes(cfg):
            ms = (8,) if name == "unembed" else (8, BATCH * PROMPT)
            cases += matmul_cases(torch, gen, flush, cfg.name, mode, name,
                                  k, n, per_forward, ms)
    # the other dense models' widest weights, base3, decode and prefill
    for arch, name, k, n in OTHER_MODEL_SHAPES:
        cases += matmul_cases(torch, gen, flush, arch, "base3", name, k, n,
                              0, (8, BATCH * PROMPT))
    # mixtral's expert weights at the bucket's expert rows
    for arch, name, k, n in MOE_SHAPES:
        cases += matmul_cases(torch, gen, flush, arch, "base3", name, k, n,
                              0, MOE_MS)
    # the recurrent models' new shapes, decode and prefill
    for arch, name, k, n in RECURRENT_SHAPES:
        cases += matmul_cases(torch, gen, flush, arch, "base3", name, k, n,
                              0, (8, BATCH * PROMPT))
    # whisper's w1 (decode, and one request's 1500 frames) and
    # llama-vision's w1 and w2 in trit2 (K = 28672: the chain splits)
    for arch, name, k, n, mode, ms in CROSS_SHAPES:
        cases += matmul_cases(torch, gen, flush, arch, mode, name, k, n, 0,
                              ms)
    return cases, floor_ms


def matmul_cases(torch, gen, flush, arch, mode, name, k, n, per_forward,
                 ms):
    """Both ternary kernels at one packed weight (K x N, random bytes and
    scales) and each M of `ms`, against their plain versions and timed
    beside a library call: one record per (M, domain), checked to agree
    and to take its route."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_matmul as tm
    dev = torch.device("cuda")
    if mode == "base3":
        data = torch.randint(0, 243, (k, n), generator=gen, device=dev,
                             dtype=torch.uint8)
    else:
        data = torch.randint(0, 256, (k // 4, n), generator=gen, device=dev,
                             dtype=torch.uint8)
    scale = torch.rand(n, generator=gen, device=dev) * 1e-2
    w = ops.PackedTernary(data, scale, mode)
    w_bf16 = ops.decode_weight(w, torch.bfloat16)
    w_int8 = ops.decode_weight(w, torch.int8)
    wbytes = data.numel() + 4 * n
    cases = []
    for m in ms:
        x = torch.randn(m, k, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        xi, xs = ops.quantize_acts_int8(x)
        for domain in ("float", "int8"):
            if domain == "float":
                run = lambda: tm.matmul_float(x, data, scale, mode)
                plain = lambda: ops.ternary_matmul_torch(x, w)
                library = lambda: torch.matmul(x, w_bf16)
                in_bytes = 2 * m * k
            else:
                run = lambda: tm.matmul_int8(xi, xs, data, scale, mode)
                plain = lambda: ops.ternary_matmul_int8_torch(xi, xs, w)
                # torch._int_mm takes M > 16 only
                library = ((lambda: torch._int_mm(xi, w_int8))
                           if m > 16 else None)
                in_bytes = m * k + 4 * m
            got, path = routed(tm, run)
            want = plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if domain == "int8":
                ok = torch.equal(got, want)
            else:
                ok = err <= FLOAT_TOL * want.abs().max().item()
                if m <= 8:          # the splits' order is fixed
                    ok = ok and torch.equal(run(), got)
            moved = in_bytes + wbytes + 4 * m * n
            sms = tm._sm_count(dev)
            plans = dict(plan=list(
                tm.gemv_plan(m, k, n, mode, sms) if m <= 8 else
                tm.mma_plan(m, k, n, sms, tm.MMA_FLOAT_CHAIN
                            if domain == "float" else None)))
            if domain == "float" and m > 8 and arch != ARCH:
                plans.update(chain_errors(torch, tm, ops, x, w, want, got))
            if m <= 8:
                # a capture now and then keeps its marker but drops the
                # call's own record (§7 of PERF.md): take it again
                for tries in range(1, 6):
                    flush.zero_()
                    busy, launched, names = device_busy(torch, run)
                    if launched:
                        break
                plans["profile_tries"] = tries
                check(launched == 1 and "tm_gemv_kernel" in names[0],
                      f"{KERNEL_NAMES[domain]} at M={m} launched "
                      f"{launched} kernels in one call: {names}")
                plans["device_ms"] = busy
            rec = dict(
                kernel=KERNEL_NAMES[domain], arch=arch, mode=mode,
                weight=name, m=m, k=k, n=n, per_forward=per_forward,
                route=path, max_abs_err=err, ok=bool(ok),
                ms=time_ms(torch, run, 20, flush),
                plain_ms=time_ms(torch, plain, 5, flush),
                library_ms=(time_ms(torch, library, 10, flush)
                            if library else None),
                bytes=moved, ops=2 * m * k * n,
                **bound(moved, 2 * m * k * n, domain), **plans)
            rec.update(rate(rec))
            cases.append(rec)
            print("[kernels] " + json.dumps(rec))
            check(ok, f"{rec['kernel']} disagrees with its plain version: "
                      f"{rec}")
            want_route = expected_route(torch, m, x.dtype)
            check(rec["route"] == want_route,
                  f"{rec['kernel']} at M={m} took route {rec['route']}, "
                  f"expected {want_route}")
    del data, w, w_bf16, w_int8
    return cases


def chain_errors(torch, tm, ops, x, w, want, got):
    """The float mma route's error against an f64 sum, relative to the
    largest output, beside the f32 plain version's and that of the same
    tiles with K in one accumulator chain (no split): what
    ``MMA_FLOAT_CHAIN`` holds back."""
    m, k = x.shape
    exact = x.double() @ (ops.decode_weight(w, torch.float64)[:k]
                          * w.scale.double()[None, :])
    top = exact.abs().max().item()
    bm = tm.mma_plan(m, k, w.data.shape[1], tm._sm_count(x.device))[0]
    chunks = -(-k // tm.MMA_K_CHUNK)
    one = torch.empty_like(got)
    check(tm.launch_mma(x, None, w.data, w.scale, w.mode, one,
                        (bm, 1, chunks * tm.MMA_K_CHUNK)) == 0,
          "mma launch with one chain failed")
    torch.cuda.synchronize()

    def rel(y):
        return (y.double() - exact).abs().max().item() / top
    out = dict(err_vs_f64=rel(got), plain_err_vs_f64=rel(want),
               one_chain_err_vs_f64=rel(one))
    check(out["err_vs_f64"] <= CHAIN_TOL,
          f"the mma route's f32 error at K={k} passes {CHAIN_TOL} of "
          f"max|y|: {out}")
    return out


def _requests(rng, vocab, n):
    from repro_torch.serve import Request
    return [Request(uid=i, prompt=rng.integers(0, vocab, size=PROMPT),
                    max_new=MAX_NEW) for i in range(n)]


def phase_serve(torch, np, cfg, model, packed):
    """Full-width serving in each domain; returns per-run records, each
    with the launch counts read right after its own run."""
    from repro_torch.core.cim_linear import CIMConfig, hbm_bytes
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serve import ServeEngine
    runs = []
    for packing, domain in (("base3", "float"), ("base3", "int8"),
                            ("trit2", "int8")):
        params = packed[packing]
        cim = CIMConfig(mode="ternary", packing=packing, domain=domain)
        eng = ServeEngine(model, params, capacity=CAPACITY,
                          max_batch=BATCH, cim=cim, device="cuda")
        check(eng.cim.backend == "cuda",
              f"auto resolved to {eng.cim.backend!r} on the card")
        rng = np.random.default_rng(7)
        for r in _requests(rng, cfg.vocab_size, BATCH):   # warm-up bucket
            r.max_new = 2
            eng.submit(r)
        eng.run()
        eng = ServeEngine(model, params, capacity=CAPACITY,
                          max_batch=BATCH, cim=cim, device="cuda")
        reqs = _requests(rng, cfg.vocab_size, BATCH)
        for r in reqs:
            eng.submit(r)
        tm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        done = eng.run()
        wall = time.monotonic() - t0
        counts, routes = dict(tm.LAUNCHES), dict(tm.ROUTES)
        kernel = KERNEL_NAMES[domain]
        check(counts[kernel] > 0, f"{kernel} never launched in the "
                                  f"{packing}/{domain} serve run")
        check(routes["mma"] > 0 and routes["gemv"] > 0
              and routes["cuda_core"] == 0,
              f"{packing}/{domain}: prefill must take the mma route and "
              f"decode the gemv route, got {routes}")
        buckets = 1
        check(eng.host_transfers == buckets,
              f"{eng.host_transfers} host transfers for {buckets} bucket")
        check(len(done) == BATCH and all(
            len(r.out_tokens) == MAX_NEW
            and all(0 <= t < cfg.padded_vocab for t in r.out_tokens)
            for r in done), "a request is missing tokens")

        # per-phase times, outside the counted run
        tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                                 device="cuda")
        prefill_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.monotonic()
            logits, state = model.prefill(params, tokens, CAPACITY,
                                          cim=eng.cim)
            torch.cuda.synchronize()
            prefill_ms.append((time.monotonic() - t) * 1e3)
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        prefill_busy, prefill_kernels, _ = device_busy(
            torch, lambda: model.prefill(params, tokens, CAPACITY,
                                         cim=eng.cim))
        step_ms, tok, state = decode_step_ms(
            torch, model, params, logits[:, -1].argmax(-1, keepdim=True),
            state, eng.cim, MAX_NEW - 2)
        # the bucket's last step, under the profiler
        decode_busy, decode_kernels, _ = device_busy(
            torch, lambda: model.decode(params, tok, state, cim=eng.cim))
        wbytes = hbm_bytes(params) - hbm_bytes(
            {k: v for k, v in params.items() if k == "embed"})
        rec = dict(packing=packing, domain=domain, requests=len(done),
                   generated_tokens=eng.generated_tokens,
                   steps=eng.steps_run, host_transfers=eng.host_transfers,
                   launches=counts, routes=routes, wall_s=wall,
                   tok_per_s=eng.generated_tokens / wall,
                   prefill_ms=statistics.median(prefill_ms),
                   prefill_device_busy_ms=prefill_busy,
                   prefill_device_idle_share=(
                       1.0 - prefill_busy / statistics.median(prefill_ms)),
                   prefill_kernels=prefill_kernels,
                   decode_step_ms=step_ms,
                   decode_device_busy_ms=decode_busy,
                   decode_device_idle_share=1.0 - decode_busy / step_ms,
                   decode_kernels=decode_kernels,
                   decode_step_bound_ms=wbytes / HBM_BYTES_PER_S * 1e3,
                   weight_bytes_per_step=wbytes)
        runs.append(rec)
        print("[serve] " + json.dumps(rec))
    return runs


def phase_parity(torch, np, cfg, model, params, tag="parity"):
    """cuda backend vs the plain torch backend on the full-width model."""
    import dataclasses
    from repro_torch.core.cim_linear import CIMConfig
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          size=(2, PROMPT)), device="cuda")
    out = {}
    for domain in ("float", "int8"):
        base = CIMConfig(mode="ternary", packing="base3", domain=domain)
        logits = {}
        feed = None
        for backend in ("cuda", "torch"):
            cim = dataclasses.replace(base, backend=backend)
            lg, state = model.prefill(params, tokens, CAPACITY, cim=cim)
            steps = [lg]
            if feed is None:
                feed = [lg[:, -1].argmax(-1, keepdim=True)]
            for i in range(4):
                lg, state = model.decode(params, feed[i], state, cim=cim)
                steps.append(lg)
                if len(feed) < 5:
                    feed.append(lg[:, -1].argmax(-1, keepdim=True))
            logits[backend] = torch.stack([s.float() for s in steps])
        a, b = logits["cuda"], logits["torch"]
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        if domain == "int8":
            ok = torch.equal(a, b)
        else:
            ok = err <= MODEL_FLOAT_TOL * scale
        out[domain] = dict(max_abs_err=err, logit_scale=scale,
                           argmax_agreement=agree, ok=bool(ok))
        print(f"[{tag}] {domain}: " + json.dumps(out[domain]))
        check(ok, f"{cfg.name} {domain}-domain logits: cuda vs torch "
                  f"{out[domain]}")
    return out


def matmul_sums(cases, kernel, mode, m):
    """Sums of one forward's packed matmuls of `kernel` at `m` rows
    (every weight at its multiplicity; a prefill has no unembedding):
    ms, plain_ms, library_ms (None where a case has none), bytes, ops and
    the number of matmuls."""
    recs = [c for c in cases if c["kernel"] == kernel and c["mode"] == mode
            and c["m"] == m and c["arch"] == ARCH]

    def total(key):
        vals = [c.get(key) for c in recs]
        if any(v is None for v in vals):
            return None
        return sum(v * c["per_forward"] for v, c in zip(vals, recs))
    out = {key: total(key) for key in ("ms", "plain_ms", "library_ms",
                                       "device_ms", "bytes", "ops")}
    out["matmuls"] = sum(c["per_forward"] for c in recs)
    return out


def kernel_summary(cases, runs, cfg, models, moe, int8kv, recurrent,
                   cross):
    """One record per kernel: the numbers of one decode step's packed
    matmuls (M = 8, base3, every weight at its multiplicity), prefill_*
    over one prefill's (M = 8 x 128, base3), and the launches of the
    base3 serve run in the kernel's domain.  Each serve run's own count
    is under ``launches_per_run``, the other models' under
    ``launches_models``, mixtral's (bucket and window runs) under
    ``launches_mixtral``, the int8-KV runs' under ``launches_int8_kv``
    and the recurrent models' (bucket and Scheduler runs) under
    ``launches_recurrent``, the cross-attending models' (bucket and
    Scheduler runs) under ``launches_cross``."""
    out = []
    prefill_m = BATCH * PROMPT
    for domain, name in KERNEL_NAMES.items():
        mine = [c for c in cases if c["kernel"] == name]
        step = matmul_sums(cases, name, "base3", 8)
        pre = matmul_sums(cases, name, "base3", prefill_m)
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/ternary_matmul.cu",
            replaces=REPLACES[domain],
            launches=next(r["launches"][name] for r in runs
                          if r["packing"] == "base3"
                          and r["domain"] == domain),
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=step["ms"], plain_ms=step["plain_ms"],
            **bound(step["bytes"], step["ops"], domain),
            library_ms=step["library_ms"],
            prefill_ms=pre["ms"], prefill_plain_ms=pre["plain_ms"],
            prefill_bound_ms=bound(pre["bytes"], pre["ops"],
                                   domain)["bound_ms"],
            prefill_library_ms=pre["library_ms"],
            workload=f"one decode step of {cfg.name}: {step['matmuls']} "
                     f"packed matmuls at M=8, base3; prefill_* over "
                     f"{pre['matmuls']} at M={prefill_m}, base3",
            launches_per_run={f"{r['packing']}/{r['domain']}":
                              r["launches"][name] for r in runs},
            launches_models={arch: m["launches"][name]
                             for arch, m in models.items()},
            launches_mixtral=dict(
                bucket=moe["launches"][name],
                window=moe["window_run"]["launches"][name]),
            launches_int8_kv=dict(
                bucket=int8kv["bucket"]["int8"]["launches"][name],
                **{kind: r["launches"][name]
                   for kind, r in int8kv["sched"].items()}),
            launches_recurrent={
                arch: dict(bucket=r["launches"][name],
                           sched=r["sched"]["launches"][name])
                for arch, r in recurrent.items()},
            launches_cross={
                arch: dict(bucket=r["launches"][name],
                           sched=r["sched"]["launches"][name])
                for arch, r in cross.items()},
            other_model_cases=[
                {key: c[key] for key in (
                    "arch", "weight", "mode", "m", "k", "n", "route",
                    "max_abs_err",
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for c in mine if c["arch"] != ARCH]))
    return out


def print_matmul_sums(cases, floor_ms):
    """Per packing, domain and phase: the summed kernel, plain, library
    and bound ms of one forward's packed matmuls, their GB/s and bound
    share, the harness floor times their count, and at decode the
    kernels' profiled device time."""
    for domain, name in KERNEL_NAMES.items():
        for mode in ("base3", "trit2"):
            for phase, m in (("decode", 8), ("prefill", BATCH * PROMPT)):
                t = matmul_sums(cases, name, mode, m)
                rec = dict(kernel=name, mode=mode, phase=phase, m=m,
                           matmuls=t["matmuls"], ms=t["ms"],
                           plain_ms=t["plain_ms"],
                           library_ms=t["library_ms"],
                           bound_ms=bound(t["bytes"], t["ops"],
                                          domain)["bound_ms"],
                           bytes=t["bytes"], device_ms=t["device_ms"],
                           floor_ms=floor_ms * t["matmuls"])
                rec.update(rate(rec))
                print("[kernels] sum " + json.dumps(rec))


def paged_operands(torch, np, dev, slots, kvh, rep, hd, ps, windows, pos,
                   seed, garbage):
    """q (pre-scaled), a pool of 1 + slots*windows pages in random order,
    tables naming each slot's live pages (the rest point at the null
    page 0), and slot 2 sharing the last slot's first page.  With
    ``garbage`` the null page holds large finite values."""
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(seed)
    num_pages = 1 + slots * windows
    q = rng.standard_normal((slots, kvh, rep, hd)) / np.sqrt(hd)
    k = rng.standard_normal((num_pages, ps, kvh, hd))
    v = rng.standard_normal((num_pages, ps, kvh, hd))
    if garbage:
        k[0] = 3e4 * rng.choice([-1.0, 1.0], size=k[0].shape)
        v[0] = 3e4 * rng.choice([-1.0, 1.0], size=v[0].shape)
    ids = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((slots, windows), np.int32)
    for i, p in enumerate(pos):
        n = min(-(-p // ps), windows)
        table[i, :n] = ids[i * windows: i * windows + n]
    if slots > 2:
        table[2, 0] = table[-1, 0]

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    kv = pa.PagedAttentionKV(t(k, torch.bfloat16), t(v, torch.bfloat16),
                             t(table, torch.int32),
                             t(np.asarray(pos), torch.int32))
    return t(q, torch.bfloat16), kv


def stats_error(torch, got, want):
    """(ok, max abs error) of (acc, m, l) against the plain version's:
    m within 1e-5 * max(1, |m|), acc and l within 1e-4 of their per-row
    maximum."""
    acc, m, l = got
    acc_r, m_r, l_r = want
    ok = (bool(((m - m_r).abs() <= 1e-5 * m_r.abs().clamp(min=1.0)).all())
          and bool(((l - l_r).abs() <= 1e-4 * l_r.abs()).all())
          and bool(((acc - acc_r).abs() <= 1e-4 * acc_r.abs().amax(
              dim=-1, keepdim=True)).all()))
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    return ok, err


def paged_bytes_ops(s, kvh, rep, hd, windows, positions):
    """Bytes and f32 operations of one paged read: the K and V rows of
    `positions` context positions (bf16), q, the page table and pos in;
    acc, m and l out; two multiply-adds per position, query and lane."""
    moved = (2 * 2 * positions * kvh * hd + 2 * s * kvh * rep * hd
             + 4 * s * windows + 4 * s
             + 4 * s * kvh * rep * hd + 2 * 4 * s * kvh * rep)
    return moved, 4 * positions * kvh * rep * hd


def paged_bounds(slots, kvh, rep, hd, windows, pos):
    """The live-context bound (what pos needs) and the full-table bound,
    in ms, with what bounds the first."""
    live = sum(min(p, windows * PAGE) for p in pos)
    moved, ops = paged_bytes_ops(slots, kvh, rep, hd, windows, live)
    moved_full, ops_full = paged_bytes_ops(slots, kvh, rep, hd, windows,
                                           slots * windows * PAGE)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_full_table_ms=max(
                    moved_full / HBM_BYTES_PER_S,
                    ops_full / PEAK_F32_OPS_PER_S) * 1e3,
                bytes_live=moved, bytes_full=moved_full)


def paged_device_ms(torch, pa, fn, flush, name, reps=3, tries=5):
    """Median over `reps` profiled calls, each after an L2 flush, of the
    kernel's own device time; each call must launch one kernel, the
    paged_attention kernel.  Now and then CUPTI hands over a capture that
    holds the end marker but no record of the call's kernel (the launch
    count shows the kernel ran); such a capture is taken again, up to
    `tries` times a call."""
    times = []
    for _ in range(reps):
        for _ in range(tries):
            flush.zero_()
            before = pa.LAUNCHES["paged_attention"]
            busy, launched, names = device_busy(torch, fn)
            # device_busy calls fn again for each capture it retakes
            check(pa.LAUNCHES["paged_attention"] > before,
                  f"paged_attention at {name} did not launch")
            if launched:
                break
        check(launched == 1 and "paged_attention_kernel" in names[0],
              f"paged_attention at {name} launched {launched} kernels in "
              f"one call: {names}")
        times.append(busy)
    return statistics.median(times)


def phase_paged_kernel(torch, np, cfg, other=False):
    """The paged_attention kernel vs its plain version on the card.  With
    `other` (another checkout's package, timed on the same cases) a case
    its wrapper refuses is recorded as refused; this checkout's kernel
    must take every case, each through the route ``load_route`` names."""
    from repro_torch import configs
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    kvh, hd = cfg.num_kv_heads, cfg.hd
    rep = cfg.num_heads // kvh
    windows = SCHED_CAPACITY // PAGE
    routes = getattr(pa, "ROUTES", None)

    def call(q, kv, name):
        """The call's result and the load route it took."""
        before = dict(routes) if routes is not None else None
        out = pa.paged_attention(q, kv)
        if routes is None:
            return out, "n/a"
        moved = [r for r in routes if routes[r] != before[r]]
        route = moved[0] if len(moved) == 1 else moved
        check(other or route == pa.load_route(kv),
              f"paged_attention at {name} took {route}")
        return out, route

    cases = [("serve ragged, garbage null page", SLOTS, kvh, rep, hd, PAGE,
              windows, [0, 1, 15, 16, 17, 511, 512, 700], True),
             ("hd 64, rep 4", 5, 2, 4, 64, PAGE, 8, [0, 5, 16, 64, 128],
              True),
             ("pages of 5, hd 40", 7, 3, 1, 40, 5, 7,
              [0, 1, 4, 5, 6, 34, 35], True),
             ("hd 20 (rows of 40 bytes: plain loads)", 6, 2, 3, 20, 4, 6,
              [0, 3, 4, 5, 23, 24], True),
             ("glm4-9b grouping, garbage null page", SLOTS, 2, 16, hd, PAGE,
              windows, [0, 1, 15, 16, 17, 511, 512, 256], True),
             ("phi3-mini-3.8b grouping (32 KV x 1, hd 96), garbage null "
              "page", SLOTS, 32, 1, 96, PAGE, windows,
              [0, 1, 15, 16, 17, 511, 512, 256], True),
             ("qwen3-14b grouping (8 KV x 5), garbage null page", SLOTS, 8,
              5, hd, PAGE, windows, [0, 1, 15, 16, 17, 511, 512, 256],
              True)]
    # the front-end pools' geometry (4 slots, 16 windows of 16), one case
    # a model, with its grouping and head dim read from its config
    for j, arch in enumerate(FE_MODELS):
        fc = configs.get(arch)
        cases.append((f"front-end {arch} ({FE_SLOTS} slots, "
                      f"{fc.num_kv_heads} KV x "
                      f"{fc.num_heads // fc.num_kv_heads}, hd {fc.hd}, "
                      f"{FE_CAPACITY // FE_PAGE} windows of {FE_PAGE}), "
                      "garbage null page", FE_SLOTS, fc.num_kv_heads,
                      fc.num_heads // fc.num_kv_heads, fc.hd, FE_PAGE,
                      FE_CAPACITY // FE_PAGE,
                      [[0, 17, 129, 256], [1, 16, 200, 255]][j], True))
    for i, (name, *shape, pos, garbage) in enumerate(cases):
        q, kv = paged_operands(torch, np, dev, *shape, pos=pos, seed=i,
                               garbage=garbage)
        try:
            got, route = call(q, kv, name)
        except ValueError as e:
            if not other:
                raise
            print(f"[paged-kernel] {name}: refused ({e})")
            continue
        torch.cuda.synchronize()
        ok, err = stats_error(torch, got, pa.paged_attention_torch(q, kv))
        check(ok, f"paged_attention disagrees with its plain version at "
                  f"{name}: max abs error {err}")
        check(all(torch.equal(a, b) for a, b in
                  zip(got, pa.paged_attention(q, kv))),
              f"two calls differ at {name}")
        clean = kv._replace(k_pages=kv.k_pages.clone(),
                            v_pages=kv.v_pages.clone())
        clean.k_pages[0] = 0
        clean.v_pages[0] = 0
        live = kv.pos > 0
        check(all(torch.equal(a[live], b[live]) for a, b in
                  zip(got, pa.paged_attention(q, clean))),
              f"the null page leaks into a live slot at {name}")
        plan = (pa.paged_plan(*shape[:6], 2)._asdict()
                if hasattr(pa, "paged_plan") else None)
        print(f"[paged-kernel] {name}: ok through {route}, max abs error "
              f"{err:.3g}, plan {plan}")
    # timed, realistic data (no garbage): the serve shape, capacity 2048
    # (a pool of 1025 pages, 67 MB of K+V), glm4-9b's grouping,
    # phi3-mini-3.8b's (32 KV x 1 at hd 96) and capacity 4096 (256
    # windows, a pool of 2049 pages, 134 MB of K+V)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    timed = [("serve", SLOTS, kvh, rep, hd, windows,
              [0, 1, 15, 16, 17, 511, 512, 256]),
             ("capacity 2048", SLOTS, kvh, rep, hd, 2048 // PAGE,
              [0, 1, 17, 512, 1000, 1536, 2047, 2048]),
             ("glm4-9b grouping", SLOTS, 2, 16, hd, windows,
              [0, 1, 15, 16, 17, 511, 512, 256]),
             ("phi3-mini-3.8b grouping", SLOTS, 32, 1, 96, windows,
              [0, 1, 15, 16, 17, 511, 512, 256]),
             ("capacity 4096", SLOTS, kvh, rep, hd, 4096 // PAGE,
              [0, 1, 17, 1000, 2048, 3000, 4095, 4096])]
    recs = []
    for i, (name, slots, h, r, d, w, pos) in enumerate(timed):
        rec = dict(case=name, shape=dict(
            slots=slots, kv_heads=h, rep=r, hd=d, page=PAGE, windows=w,
            pool_pages=1 + slots * w, pos=pos, dtype="bf16"),
            **paged_bounds(slots, h, r, d, w, pos))
        q, kv = paged_operands(torch, np, dev, slots, h, r, d, PAGE, w,
                               pos, seed=9 + i, garbage=False)
        try:
            got, route = call(q, kv, name)
        except ValueError as e:
            if not other:
                raise
            rec.update(refused=str(e), ms=None, device_ms=None)
            print("[paged-kernel] " + json.dumps(rec))
            recs.append(rec)
            continue
        ok, worst = stats_error(torch, got, pa.paged_attention_torch(q, kv))
        check(ok, f"paged_attention disagrees at {name} ({worst})")
        plan = (pa.paged_plan(slots, h, r, d, PAGE, w, 2)._asdict()
                if hasattr(pa, "paged_plan") else None)
        fn = lambda: pa.paged_attention(q, kv)      # noqa: E731
        rec.update(
            route=route, plan=plan, max_abs_err=worst,
            ms=time_ms(torch, fn, 50, flush),
            device_ms=paged_device_ms(torch, pa, fn, flush, name),
            plain_ms=time_ms(torch, lambda: pa.paged_attention_torch(q, kv),
                             10, flush),
            library_ms=None,
            library_reason="no PyTorch call returns the unnormalised flash "
                           "statistics (acc, m, l) of a paged context")
        rec["gbps_live"] = rec["bytes_live"] / rec["device_ms"] / 1e6
        rec["bound_share_device"] = rec["bound_ms"] / rec["device_ms"]
        print("[paged-kernel] " + json.dumps(rec))
        recs.append(rec)
    serve = dict(recs[0])
    serve["ms_per_step"] = serve["ms"] * cfg.num_layers
    serve["device_ms_per_step"] = serve["device_ms"] * cfg.num_layers
    serve["cases"] = recs
    return serve


def sched_requests(np, cfg, seed):
    """The bursty trace: 2 bursts of 8; in each, 7 short requests share a
    128-token system prompt followed by 16-48 tokens of their own
    (max_new 16-32), and one long request has a 384-token prompt
    (max_new 32)."""
    from repro_torch.serve import bursty_arrivals
    arrivals = bursty_arrivals(16, bursts=2, gap_s=0.25, seed=seed)
    rng = np.random.default_rng(seed)
    system = [rng.integers(0, cfg.vocab_size, 128) for _ in range(2)]
    specs = []
    for i, arrival in enumerate(arrivals):
        if i % 8 == 7:
            prompt, max_new = rng.integers(0, cfg.vocab_size, 384), 32
        else:
            own = rng.integers(0, cfg.vocab_size, int(rng.integers(16, 49)))
            prompt = np.concatenate([system[i // 8], own])
            max_new = int(rng.integers(16, 33))
        specs.append((i, prompt.astype(np.int32), max_new, arrival))
    return specs


def make_scheduler(kind, model, params, cim, capacity=SCHED_CAPACITY,
                   **mesh_kw):
    """A scheduler of ``kind`` (dense, gather, fused) on the card;
    ``mesh_kw`` (``rules=, mesh=``) puts it on a mesh."""
    from repro_torch.serve import PagedScheduler, Scheduler
    if kind == "dense":
        return Scheduler(model, params, capacity=capacity,
                         slots=SLOTS, chunk=CHUNK, cim=cim, device="cuda",
                         **mesh_kw)
    return PagedScheduler(model, params, capacity=capacity,
                          slots=SLOTS, chunk=CHUNK, page_size=PAGE, cim=cim,
                          fused_attn="auto" if kind == "fused" else False,
                          device="cuda", **mesh_kw)


def first_divergence(torch, model, params, cim, prompt, want, got,
                     capacity=SCHED_CAPACITY):
    """Where two token lists of one request first differ: the step, and
    the top-2 margin and scale of the logits there, taken by feeding
    `want`'s tokens through the dense decode."""
    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    tokens = torch.as_tensor(prompt[None], device="cuda")
    logits, state = model.prefill(params, tokens, capacity, cim=cim)
    for t in want[:j]:
        logits, state = model.decode(
            params, torch.tensor([[t]], device="cuda"), state, cim=cim)
    top = logits[0, -1].float().topk(2).values
    scale = logits[0, -1].float().abs().max().item()
    return dict(step=j, margin=(top[0] - top[1]).item(), scale=scale,
                want=want[j], got=got[j])


def phase_sched(torch, np, cfg, model, params, specs=None,
                kinds=("dense", "gather", "fused"), capacity=SCHED_CAPACITY,
                tag="sched", mesh_kw=None):
    """Schedulers of `kinds` (dense, gather, fused) on one trace (by
    default the bursty trace), on a mesh with ``mesh_kw``; returns
    records and the fused-vs-gather parity (without a fused run: every
    run's tokens)."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serve import Request, latency_stats
    cim = CIMConfig(mode="ternary", packing="base3", domain="float")
    if specs is None:
        specs = sched_requests(np, cfg, seed=21)
    runs, tokens = {}, {}
    for kind in kinds:
        eng = make_scheduler(kind, model, params, cim, capacity,
                             **(mesh_kw or {}))
        if kind == "fused":
            check(eng.attn_plan is not None
                  and eng.attn_plan.backend == "paged_attn",
                  f"fused_attn='auto' resolved {eng.attn_plan} on the card")
        for uid, prompt, max_new, arrival in specs:
            eng.submit(Request(uid=uid, prompt=prompt, max_new=max_new,
                               arrival_s=arrival))
        rounds = []
        serve_round = eng._serve_round

        def timed(elapsed, serve_round=serve_round, rounds=rounds):
            t = time.monotonic()
            serve_round(elapsed)
            rounds.append(time.monotonic() - t)
        eng._serve_round = timed
        torch.cuda.synchronize()
        tm.reset_launches()
        pa.reset_launches()
        t0 = time.monotonic()
        done = eng.run()
        wall = time.monotonic() - t0
        launches = {**tm.LAUNCHES, **pa.LAUNCHES}
        routes = dict(tm.ROUTES)
        steps_launched = eng.chunk * eng.chunks_run
        paged = kind != "dense"
        rec = dict(
            kind=kind, requests=len(done),
            generated_tokens=eng.generated_tokens, wall_s=wall,
            tok_per_s=eng.generated_tokens / wall,
            p50_s=latency_stats(done)["p50_s"],
            p99_s=latency_stats(done)["p99_s"],
            decode_ms_per_step=sum(rounds) * 1e3 / steps_launched,
            chunks=eng.chunks_run, host_transfers=eng.host_transfers,
            decode_steps=eng.decode_steps, steps_launched=steps_launched,
            slot_occupancy=eng.slot_occupancy,
            kv_bytes_pool=eng.kv_bytes(),
            kv_bytes_resident_peak=(eng.kv_bytes_resident_peak if paged
                                    else eng.kv_bytes()),
            pages_in_use_peak=eng.pages_in_use_peak if paged else None,
            prefix_hit_rate=eng.prefix_hit_rate if paged else None,
            attn_backend=(eng.attn_plan.backend
                          if paged and eng.attn_plan else None),
            launches=launches, routes=routes)
        print(f"[{tag}] " + json.dumps(rec))
        runs[kind] = rec
        tokens[kind] = {r.uid: [int(t) for t in r.out_tokens] for r in done}
        check(len(done) == len(specs) and all(
            len(r.out_tokens) == r.max_new for r in done),
            f"{kind}: a request is missing tokens")
        check(eng.host_transfers == eng.chunks_run,
              f"{kind}: {eng.host_transfers} host transfers for "
              f"{eng.chunks_run} chunks")
        check(launches["ternary_matmul"] > 0,
              f"{kind}: ternary_matmul never launched")
        want = cfg.num_layers * steps_launched if kind == "fused" else 0
        check(launches["paged_attention"] == want,
              f"{kind}: paged_attention launched "
              f"{launches['paged_attention']} times, expected {want}")
        del eng
    prompts = {uid: prompt for uid, prompt, _, _ in specs}
    if "dense" in runs:
        dense_peak = runs["dense"]["kv_bytes_resident_peak"]
        for kind in [k for k in ("gather", "fused") if k in runs]:
            peak = runs[kind]["kv_bytes_resident_peak"]
            check(peak <= dense_peak / 2,
                  f"{kind}: resident KV peak {peak} is not <= half the "
                  f"dense pool's {dense_peak}")
            check(runs[kind]["prefix_hit_rate"] > 0,
                  f"{kind}: no prefix hit")
        bad = [u for u in prompts
               if tokens["gather"][u] != tokens["dense"][u]]
        for u in bad:
            print(f"[{tag}] gather != dense " + json.dumps(
                dict(uid=u, **first_divergence(
                    torch, model, params, cim, prompts[u],
                    tokens["dense"][u], tokens["gather"][u], capacity))))
        check(not bad, f"gather tokens differ from dense for requests {bad}")
    if "fused" not in runs:
        return runs, tokens
    mism = [u for u in prompts if tokens["fused"][u] != tokens["gather"][u]]
    ties = []
    for u in mism:
        d = dict(uid=u, **first_divergence(torch, model, params, cim,
                                           prompts[u], tokens["gather"][u],
                                           tokens["fused"][u], capacity))
        print(f"[{tag}] fused != gather " + json.dumps(d))
        ties.append(d)
    total = sum(len(t) for t in tokens["gather"].values())
    agree = sum(a == b for u in prompts
                for a, b in zip(tokens["gather"][u], tokens["fused"][u]))
    parity = dict(fused_identical=not mism, mismatched_requests=mism,
                  argmax_agreement=agree / total,
                  largest_margin_at_mismatch=max(
                      (d["margin"] / d["scale"] for d in ties), default=None))
    print(f"[{tag}] fused vs gather " + json.dumps(parity))
    check(all(d["margin"] <= NEAR_TIE * d["scale"] for d in ties),
          f"fused tokens differ from gather beyond a near tie: {ties}")
    return runs, parity


def hold_tuned_plan(torch, gen, e, flush=None):
    """One table entry's plan through its wrapper (``tiles``) on operands
    of its cell, held to the plain version: int8 bitwise, float within
    FLOAT_TOL of max|y|, and a float mma plan's error against an f64 sum
    within CHAIN_TOL; timed beside the rule's plan when ``flush`` is
    given.  Returns a record."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_matmul as tm
    m, k, n, mode, domain = e["m"], e["k"], e["n"], e["packing"], e["domain"]
    dev = torch.device("cuda")
    kw = k // 4 if mode == "trit2" else k
    data = torch.randint(0, 256 if mode == "trit2" else 243, (kw, n),
                         generator=gen, device=dev, dtype=torch.uint8)
    scale = torch.rand(n, generator=gen, device=dev) * 1e-2
    w = ops.PackedTernary(data, scale, mode)
    x = torch.randn(m, k, generator=gen, device=dev, dtype=torch.bfloat16)
    tiles = tuple(e["blocks"])
    if domain == "int8":
        xi, xs = ops.quantize_acts_int8(x)
        run = lambda t=tiles: tm.matmul_int8(xi, xs, data, scale, mode,  # noqa: E731
                                             tiles=t)
        want = ops.ternary_matmul_int8_torch(xi, xs, w)
    else:
        run = lambda t=tiles: tm.matmul_float(x, data, scale, mode,  # noqa: E731
                                              tiles=t)
        want = ops.ternary_matmul_torch(x, w)
    got, path = routed(tm, run)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rec = dict(m=m, k=k, n=n, mode=mode, domain=domain, route=path,
               blocks=list(tiles), heuristic_blocks=e["heuristic_blocks"],
               max_abs_err=err)
    if domain == "int8":
        ok = torch.equal(got, want)
    else:
        ok = err <= FLOAT_TOL * want.abs().max().item()
        if path == "mma":
            rec.update(chain_errors(torch, tm, ops, x, w, want, got))
    check(path == expected_route(torch, m, x.dtype),
          f"tuned plan {tiles} at {(m, k, n)} took route {path}")
    check(ok, f"tuned plan {tiles} at {(m, k, n)} {mode}/{domain} "
              f"disagrees with the plain version: {rec}")
    if flush is not None:
        rec["ms"] = time_ms(torch, run, 20, flush)
        rec["heuristic_ms"] = time_ms(
            torch, lambda: run(tuple(e["heuristic_blocks"])), 20, flush)
    del data, w, x, want, got
    return rec


def autotune_bucket(torch, np, cfg, model, params, domain, source):
    """The bucket ServeEngine of the serve phase (8 x 128 prompt tokens,
    MAX_NEW new) at full width, base3, its plans resolved from the
    tracked table (``source='autotune'``) or from the rules alone
    (``'heuristic'``: the table disabled); every plan a run executes is
    recorded.  Returns the run's record and its tokens."""
    import os
    import repro_torch.kernels as kernels
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.kernels import autotune
    from repro_torch.serve import ServeEngine
    if source == "heuristic":
        os.environ[autotune.ENV_VAR] = ""
    else:
        os.environ.pop(autotune.ENV_VAR, None)
    autotune.reload_table()
    cim = CIMConfig(mode="ternary", packing="base3", domain=domain)
    rng = np.random.default_rng(7)
    warm = ServeEngine(model, params, capacity=CAPACITY, max_batch=BATCH,
                       cim=cim, device="cuda")
    for r in _requests(rng, cfg.vocab_size, BATCH):
        r.max_new = 2
        warm.submit(r)
    warm.run()
    seen = {}
    execute = kernels.execute

    def recorded(plan, x, w):
        if plan.op == "ternary":
            seen[plan.shape] = plan
        return execute(plan, x, w)
    eng = ServeEngine(model, params, capacity=CAPACITY, max_batch=BATCH,
                      cim=cim, device="cuda")
    reqs = _requests(rng, cfg.vocab_size, BATCH)
    for r in reqs:
        eng.submit(r)
    kernels.execute = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        done = eng.run()
        wall = time.monotonic() - t0
    finally:
        kernels.execute = execute
    sources = {}
    for plan in seen.values():
        sources[plan.block_source] = sources.get(plan.block_source, 0) + 1
    tokens = {r.uid: [int(t) for t in r.out_tokens] for r in done}
    prompts = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                              device="cuda")
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.monotonic()
        logits, state = model.prefill(params, prompts, CAPACITY, cim=eng.cim)
        torch.cuda.synchronize()
        prefill_ms.append((time.monotonic() - t) * 1e3)
    step_ms, _, _ = decode_step_ms(
        torch, model, params, logits[:, -1].argmax(-1, keepdim=True), state,
        eng.cim, AUTOTUNE_STEPS)
    rec = dict(domain=domain, source=source, plans=len(seen),
               block_sources=sources, wall_s=wall,
               tok_per_s=eng.generated_tokens / wall,
               prefill_ms=statistics.median(prefill_ms),
               decode_step_ms=step_ms, host_transfers=eng.host_transfers,
               plan_table=sorted([list(p.shape), p.block_source,
                                  list(p.blocks) if p.blocks else None]
                                 for p in seen.values()))
    check(eng.host_transfers == 1, f"{eng.host_transfers} transfers for one "
                                   f"bucket")
    return rec, tokens, {r.uid: r.prompt for r in reqs}, eng.cim


def phase_autotune(torch, np, cfg, model, params, card):
    """The measured tile table at full width: a --fast sweep of the main
    path's cells into chiprun_out/ (never the tracked table); every plan
    of that sweep and of the tracked table held to its plain version (and
    the float chain); then the base3 bucket runs in both domains, resolved
    from the tracked table and from the rules, side by side."""
    import os
    from repro_torch.kernels import autotune
    device = torch.cuda.get_device_name(0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    scratch = out_dir / "autotune_fast.json"
    scratch.unlink(missing_ok=True)
    t = time.monotonic()
    fresh = autotune.tune(fast=True)
    autotune.save_table(fresh, str(scratch))
    tune_s = time.monotonic() - t
    tracked = [e for e in autotune.load_entries(autotune.DEFAULT_TABLE)
               if e["device"] == device]
    check(tracked, f"the tracked table holds no entry for {device!r}")
    check(set(autotune.sweep_cells(device)) <= {autotune._entry_key(e)
                                                 for e in tracked},
          "the tracked table does not cover the sweep on this card")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(27)
    held, main = [], set(autotune.main_path_shapes())
    plans = {(e["m"], e["k"], e["n"], e["packing"], e["domain"],
              tuple(e["blocks"])) for e in tracked}
    # the fast sweep's plans the tracked table holds too are held once
    fresh_only = [e for e in fresh if (e["m"], e["k"], e["n"], e["packing"],
                                       e["domain"], tuple(e["blocks"]))
                  not in plans]
    for tag, entries in (("fast", fresh_only), ("tracked", tracked)):
        for e in entries:
            timed = tag == "tracked" and (e["m"], e["k"], e["n"]) in main
            rec = hold_tuned_plan(torch, gen, e, flush if timed else None)
            rec["table"] = tag
            held.append(rec)
            if timed:
                print("[autotune] " + json.dumps(rec))
    changed = sum(e["blocks"] != e["heuristic_blocks"] for e in tracked)
    sums = step_sums(cfg, [r for r in held if "ms" in r])
    for key, rec in sums.items():
        print(f"[autotune] step sums {key} " + json.dumps(rec))
    print("[autotune] " + json.dumps(dict(
        tune_s=tune_s, fast_cells=len(fresh), tracked_cells=len(tracked),
        tracked_not_the_rule=changed, plans_held=len(held), card=card)))
    runs, tokens = {}, {}
    for domain in ("float", "int8"):
        for source in ("autotune", "heuristic"):
            rec, tokens[domain, source], prompts, cim = autotune_bucket(
                torch, np, cfg, model, params, domain, source)
            runs[f"{domain}/{source}"] = rec
            print("[autotune] bucket " + json.dumps(
                {k: v for k, v in rec.items() if k != "plan_table"}))
        tuned = runs[f"{domain}/autotune"]
        check(tuned["block_sources"] == {"autotune": tuned["plans"]},
              f"{domain}: every plan of the bucket run must come from the "
              f"table: {tuned['block_sources']}")
        check(runs[f"{domain}/heuristic"]["block_sources"]
              == {"heuristic": tuned["plans"]},
              f"{domain}: the table-less run resolved "
              f"{runs[f'{domain}/heuristic']['block_sources']}")
        a, b = tokens[domain, "autotune"], tokens[domain, "heuristic"]
        bad = [u for u in a if a[u] != b[u]]
        ties = []
        for u in bad:
            d = dict(uid=u, **first_divergence(torch, model, params, cim,
                                               prompts[u], b[u], a[u],
                                               CAPACITY))
            print("[autotune] tuned != rule " + json.dumps(d))
            ties.append(d)
        runs[f"{domain}/tokens"] = dict(identical=not bad, mismatched=bad,
                                        divergences=ties)
        if domain == "int8":
            check(not bad, f"int8 tokens differ between the tuned and the "
                           f"rule's plans for requests {bad}")
        else:
            check(all(d["margin"] <= NEAR_TIE * d["scale"] for d in ties),
                  f"float tokens differ beyond a near tie: {ties}")
    os.environ.pop(autotune.ENV_VAR, None)
    autotune.reload_table()
    return dict(tune_s=tune_s, fast=fresh, held=held, runs=runs,
                tracked_not_the_rule=changed, step_sums=sums)


def step_sums(cfg, timed):
    """Per packing and domain, the matmuls of one decode step (every
    weight at M = 8) and of one prefill of 8 x 128 tokens (the layers at
    M = 1024, the unembedding at M = 8), summed from the timed plans:
    the tuned table's and the rule's ms."""
    ms = {(r["mode"], r["domain"], r["m"], r["k"], r["n"]): r
          for r in timed}
    out = {}
    for mode in ("base3", "trit2"):
        for domain in ("float", "int8"):
            rec = dict(decode_ms=0.0, decode_rule_ms=0.0, prefill_ms=0.0,
                       prefill_rule_ms=0.0, calls=0)
            for name, k, n, per in layer_shapes(cfg):
                d = ms[mode, domain, 8, k, n]
                p = d if name == "unembed" else \
                    ms[mode, domain, BATCH * PROMPT, k, n]
                rec["decode_ms"] += per * d["ms"]
                rec["decode_rule_ms"] += per * d["heuristic_ms"]
                rec["prefill_ms"] += per * p["ms"]
                rec["prefill_rule_ms"] += per * p["heuristic_ms"]
                rec["calls"] += per
            out[f"{mode}/{domain}"] = rec
    return out


def phase_sanitize(torch, np, cfg, model, params, kinds=None, mesh_kw=None,
                   tag="sanitize"):
    """The four engines at full width (base3 / float) under
    ``repro_torch.analysis.sanitize``: the bucket ServeEngine, the dense
    Scheduler and the PagedScheduler's gather and fused reads, each
    warmed on 8 requests and then serving 8 more of the same lengths with
    ``set_sync_debug_mode('error')`` on everywhere but the transfer
    chokepoint: one transfer per chunk (per bucket), no other sync, no
    new plan and no build.  ``kinds`` picks engines, ``mesh_kw`` (``rules=,
    mesh=``) puts the schedulers on a mesh."""
    from repro_torch.analysis import sanitizer
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.serve import Request, ServeEngine
    cim = CIMConfig(mode="ternary", packing="base3", domain="float")
    rng = np.random.default_rng(22)
    ragged = [int(x) for x in rng.integers(96, 161, size=BATCH)]

    def reqs(base, lens):
        return [Request(uid=base + i, prompt=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32), max_new=16)
            for i, n in enumerate(lens)]
    out = {}
    for kind in kinds or sanitizer.ENGINES:
        if kind == "bucket":        # one bucket: one prompt length
            eng = ServeEngine(model, params, capacity=SCHED_CAPACITY,
                              max_batch=BATCH, cim=cim, device="cuda")
            lens = [PROMPT] * BATCH
        else:
            eng = make_scheduler(kind, model, params, cim,
                                 **(mesh_kw or {}))
            lens = ragged
        warm, measured = reqs(0, lens), reqs(100, lens)
        counts = {}
        findings = sanitizer.check_engine(eng, kind, warm, measured,
                                          counts=counts)
        rec = dict(kind=kind, findings=[str(f) for f in findings], **counts)
        print(f"[{tag}] " + json.dumps(rec))
        check(not findings, f"{kind}: {findings}")
        check(counts["sync_guard"] and counts["transfers"] == counts["chunks"]
              and counts["new_plans"] == 0 and counts["builds"] == 0,
              f"{kind}: {counts}")
        out[kind] = rec
        del eng
    return out


def phase_analysis(torch):
    """``python -m repro_torch.analysis`` on the card, in a process of its
    own: every pass, the capability pass executing the cuda cells too,
    the sanitize and frontend passes serving on the card under the sync
    guard."""
    import os
    report = ROOT / "chiprun_out" / "analysis.json"
    report.parent.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           "--device", "cuda", "--out", str(report)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    seconds = time.monotonic() - t
    for line in proc.stdout.splitlines():
        print(f"[analysis] {line}")
    check(proc.returncode == 0,
          f"python -m repro_torch.analysis exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    doc = json.loads(report.read_text())
    check("shard" in [p["name"] for p in doc["passes"]],
          "the analysis CLI ran no shard pass")
    return dict(seconds=seconds, passes=doc["passes"], ok=doc["ok"])


def forward_matmuls(cfg):
    """Packed matmuls of one forward (every layer's seven, then the
    unembedding)."""
    return sum(c[3] for c in layer_shapes(cfg))


def cut_depth(cfg, params, layers):
    """The config and params of the model's first `layers` layers (views,
    no copy): the same widths, a shorter stack."""
    import dataclasses
    layers = min(layers, cfg.num_layers)
    blocks = {k: v[:layers] for k, v in params["blocks"].items()}
    return (dataclasses.replace(cfg, num_layers=layers),
            {**params, "blocks": blocks})


def phase_model(torch, np, arch):
    """One of the other dense models at full width (SERVE_LAYERS): seeded
    random bf16 weights on the card packed to base3, the bucket
    ServeEngine on 8 requests x 128 prompt tokens x MODELS_NEW new ones
    (counts zeroed just before the run and read just after), per-phase
    times beside the decode bytes floor, the cuda-vs-torch parity on the
    first PARITY_LAYERS layers, and for SCHED_ARCH the PagedScheduler,
    fused against gather, on the first SCHED_CUT requests of the bursty
    trace.  The model is freed before the next one."""
    from repro_torch.core.cim_linear import (CIMConfig, hbm_bytes,
                                             ternarize_params)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import registry
    from repro_torch.serve import Request, ServeEngine
    cfg = serve_cfg(arch)
    model = registry.build(cfg)
    cim = CIMConfig(mode="ternary", packing="base3", domain="float")
    t = time.monotonic()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t
    raw_bytes = hbm_bytes(params)
    t = time.monotonic()
    packed = ternarize_params(params, cim)
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(17)
    warm = ServeEngine(model, packed, capacity=CAPACITY, max_batch=BATCH,
                       cim=cim, device="cuda")
    for r in _requests(rng, cfg.vocab_size, BATCH):
        r.max_new = 2
        warm.submit(r)
    warm.run()
    eng = ServeEngine(model, packed, capacity=CAPACITY, max_batch=BATCH,
                      cim=cim, device="cuda")
    check(eng.cim.backend == "cuda",
          f"{arch}: auto resolved to {eng.cim.backend!r} on the card")
    reqs = _requests(rng, cfg.vocab_size, BATCH)
    for r in reqs:
        r.max_new = MODELS_NEW
        eng.submit(r)
    tm.reset_launches()
    pa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = eng.run()
    wall = time.monotonic() - t0
    launches, routes = dict(tm.LAUNCHES), dict(tm.ROUTES)
    per_forward = forward_matmuls(cfg)
    check(launches["ternary_matmul"] == per_forward * MODELS_NEW
          and launches["ternary_matmul_int8"] == 0,
          f"{arch}: {launches} ternary launches, expected {per_forward} a "
          f"forward x {MODELS_NEW} forwards")
    check(routes["mma"] > 0 and routes["gemv"] > 0
          and routes["cuda_core"] == 0,
          f"{arch}: prefill must take the mma route and decode the gemv "
          f"route, got {routes}")
    check(eng.host_transfers == 1,
          f"{arch}: {eng.host_transfers} host transfers for 1 bucket")
    check(len(done) == BATCH and all(
        len(r.out_tokens) == MODELS_NEW
        and all(0 <= tok < cfg.padded_vocab for tok in r.out_tokens)
        for r in done), f"{arch}: a request is missing tokens")

    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             device="cuda")
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.monotonic()
        logits, state = model.prefill(packed, tokens, CAPACITY, cim=eng.cim)
        torch.cuda.synchronize()
        prefill_ms.append((time.monotonic() - t) * 1e3)
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    step_ms, tok, state = decode_step_ms(
        torch, model, packed, logits[:, -1].argmax(-1, keepdim=True), state,
        eng.cim, MODELS_NEW - 2)
    try:
        busy, kernels, _ = device_busy(torch, lambda: model.decode(
            packed, tok, state, cim=eng.cim))
    except SmokeError as e:             # the profile is a reading only
        print(f"[models] {arch}: no decode profile ({e})")
        busy = kernels = None
    del state, logits
    wbytes = hbm_bytes(packed) - hbm_bytes(
        {k: v for k, v in packed.items() if k == "embed"})
    rec = dict(
        arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, hd=cfg.hd,
        d_ff=cfg.d_ff, padded_vocab=cfg.padded_vocab, qk_norm=cfg.qk_norm,
        init_s=init_s, pack_s=pack_s, bf16_weight_bytes=raw_bytes,
        packed_weight_bytes=hbm_bytes(packed),
        decode_weight_bytes=wbytes,
        decode_step_bound_ms=wbytes / HBM_BYTES_PER_S * 1e3,
        requests=len(done), generated_tokens=eng.generated_tokens,
        steps=eng.steps_run, host_transfers=eng.host_transfers,
        launches=launches, routes=routes,
        matmuls_per_forward=per_forward, wall_s=wall,
        tok_per_s=eng.generated_tokens / wall,
        prefill_ms=statistics.median(prefill_ms), decode_step_ms=step_ms,
        decode_device_busy_ms=busy, decode_kernels=kernels,
        decode_device_idle_share=(1.0 - busy / step_ms if busy else None))
    print("[models] " + json.dumps(rec))
    del eng, warm
    cut_cfg, cut_params = cut_depth(cfg, packed, PARITY_LAYERS)
    rec["parity_layers"] = cut_cfg.num_layers
    rec["parity"] = phase_parity(torch, np, cut_cfg, registry.build(cut_cfg),
                                 cut_params, tag=f"models {arch} parity")
    del cut_params
    if arch == SCHED_ARCH:
        specs = sched_requests(np, cfg, seed=21)[:SCHED_CUT]
        runs, parity = phase_sched(torch, np, cfg, model, packed,
                                   specs=specs, kinds=("gather", "fused"),
                                   tag=f"models {arch} sched")
        rec["sched"] = runs
        rec["sched_parity"] = parity
    del packed
    torch.cuda.empty_cache()
    return rec


def moe_forward_matmuls(cfg):
    """Packed matmuls of one MoE forward: each layer's four attention
    projections and its experts' three weights (one call per expert and
    weight over every routing group), then the unembedding."""
    return cfg.num_layers * (4 + 3 * cfg.num_experts) + 1


def matmul_shapes(torch, tm, fn):
    """fn()'s result and a count of the (M, K, N) of every float-domain
    ternary_matmul call it made (the wrapper runs as always)."""
    seen = {}
    wrapped = tm.matmul_float

    def recording(x, data, scale, mode, tiles=None):
        k = x.shape[1]
        key = (x.shape[0], k, data.shape[1])
        seen[key] = seen.get(key, 0) + 1
        return wrapped(x, data, scale, mode, tiles=tiles)
    tm.matmul_float = recording
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        tm.matmul_float = wrapped
    return out, seen


def moe_window_run(torch, np, model, params, cfg, cim, prompts, tag):
    """The dense Scheduler (WIN_SLOTS slots, chunk WIN_CHUNK, capacity
    WIN_CAPACITY) on one request per prompt with WIN_NEW new tokens:
    (record, tokens by uid).  The pool must hold the window, not the
    capacity, and take one transfer per chunk."""
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serve import Request, Scheduler
    eng = Scheduler(model, params, capacity=WIN_CAPACITY, slots=WIN_SLOTS,
                    chunk=WIN_CHUNK, cim=cim, device="cuda")
    window = cfg.sliding_window
    kv = eng.kv_bytes()
    want_kv = (2 * cfg.num_layers * WIN_SLOTS * window * cfg.num_kv_heads
               * cfg.hd * 2)
    check(eng.pool["k"].shape[2] == window and kv == want_kv,
          f"{tag}: the pool holds {tuple(eng.pool['k'].shape)} "
          f"({kv} bytes), not the window's {want_kv}")
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt, max_new=WIN_NEW))
    torch.cuda.synchronize()
    tm.reset_launches()
    t0 = time.monotonic()
    done = eng.run()
    wall = time.monotonic() - t0
    launches, routes = dict(tm.LAUNCHES), dict(tm.ROUTES)
    steps_launched = eng.chunk * eng.chunks_run
    want = (moe_forward_matmuls(cfg) * (len(prompts) + steps_launched)
            if eng.cim.backend == "cuda" else 0)
    check(launches["ternary_matmul"] == want,
          f"{tag}: {launches} ternary launches, expected {want} (a forward "
          f"per prefill and per decode step launched)")
    check(eng.host_transfers == eng.chunks_run,
          f"{tag}: {eng.host_transfers} host transfers for "
          f"{eng.chunks_run} chunks")
    check(len(done) == len(prompts) and all(
        len(r.out_tokens) == WIN_NEW
        and all(0 <= t < cfg.padded_vocab for t in r.out_tokens)
        for r in done), f"{tag}: a request is missing tokens")
    rec = dict(backend=eng.cim.backend, prompts=[len(p) for p in prompts],
               new=WIN_NEW, capacity=WIN_CAPACITY, window=window,
               pool_positions=eng.pool["k"].shape[2], kv_bytes_pool=kv,
               kv_bytes_at_capacity=want_kv * WIN_CAPACITY // window,
               chunks=eng.chunks_run, host_transfers=eng.host_transfers,
               decode_steps=eng.decode_steps, steps_launched=steps_launched,
               wall_s=wall, tok_per_s=eng.generated_tokens / wall,
               launches=launches, routes=routes)
    print(f"[{tag}] " + json.dumps(rec))
    return rec, {r.uid: [int(t) for t in r.out_tokens] for r in done}


def moe_parity(torch, np, cfg, model, params, prompts):
    """The window run's requests on the first PARITY_LAYERS layers
    through the cuda backend (resolved by 'auto') and the plain torch
    backend: Scheduler tokens equal or a near tie at the first
    divergence; and the logits of a prefill and WIN_NEW - 1 decode steps
    per prompt, fed the cuda run's tokens (the 4064-token prompt decodes
    across the window), with every routing call of the torch run taking
    the cuda run's top-k choices of the same call: the two then differ
    by the products' round-off alone, and every step's logits, the
    prefills' included, must agree within MODEL_FLOAT_TOL of the logit
    scale.  Where the torch run's own top-k would have chosen otherwise,
    the choice must be a router near tie (top-k turns round-off at a
    near tie into another expert)."""
    from repro_torch.core.cim_linear import CIMConfig
    runs = {}
    for backend in ("auto", "torch"):
        cim = CIMConfig(mode="ternary", packing="base3", domain="float",
                        backend=backend)
        rec, toks = moe_window_run(torch, np, model, params, cfg, cim,
                                   prompts, f"moe parity {backend}")
        runs[backend] = (rec, toks)
    check(runs["auto"][0]["backend"] == "cuda",
          f"'auto' resolved {runs['auto'][0]['backend']!r} on the card")
    cuda_toks, plain_toks = runs["auto"][1], runs["torch"][1]
    ties = []
    for uid, prompt in enumerate(prompts):
        if cuda_toks[uid] != plain_toks[uid]:
            cim = CIMConfig(mode="ternary", packing="base3", domain="float",
                            backend="cuda")
            ties.append(dict(uid=uid, **first_divergence(
                torch, model, params, cim, prompt, plain_toks[uid],
                cuda_toks[uid], WIN_CAPACITY)))
    steps = []
    for uid, prompt in enumerate(prompts):
        feed = cuda_toks[uid][:-1]
        cuda = routed_logits(torch, model, params, CIMConfig(
            mode="ternary", packing="base3", domain="float",
            backend="cuda"), prompt, feed)
        plain = routed_logits(torch, model, params, CIMConfig(
            mode="ternary", packing="base3", domain="float",
            backend="torch"), prompt, feed, forced=cuda)
        for j, (a, b) in enumerate(zip(cuda, plain)):
            margins = routing_flips(torch, a[1], b[1])
            scale = b[0].abs().max().item()
            steps.append(dict(
                uid=uid, step=j, max_abs_err=(a[0] - b[0]).abs().max()
                .item(), logit_scale=scale,
                same_argmax=bool(a[0].argmax() == b[0].argmax()),
                routing_flips=len(margins),
                largest_flip_margin=max(margins, default=None)))
    worst = max(steps, key=lambda d: d["max_abs_err"] / d["logit_scale"])
    flipped = [d for d in steps if d["routing_flips"]]
    out = dict(layers=cfg.num_layers, tokens_identical=not ties,
               first_divergences=ties, logit_steps=len(steps),
               worst_step=worst, prefills=[d for d in steps
                                           if d["step"] == 0],
               flipped_steps=flipped,
               argmax_agreement=sum(d["same_argmax"] for d in steps)
               / len(steps),
               window_runs={k: v[0] for k, v in runs.items()})
    print("[moe parity] " + json.dumps({k: v for k, v in out.items()
                                        if k != "window_runs"}))
    check(all(d["margin"] <= NEAR_TIE * d["scale"] for d in ties),
          f"cuda tokens differ from the plain path's beyond a near tie: "
          f"{ties}")
    check(all(d["largest_flip_margin"] <= NEAR_TIE for d in flipped),
          f"a routing choice of the torch run differs from the cuda "
          f"run's beyond a router near tie: {flipped}")
    check(all(d["max_abs_err"] <= MODEL_FLOAT_TOL * d["logit_scale"]
              for d in steps), f"cuda vs torch logits: {worst}")
    return out


def routed_logits(torch, model, params, cim, prompt, feed, forced=None):
    """[(last-position logits, [(router logits (G, g, E), own top-k
    choices (G, g, k)) of each routing call])] of a prefill of `prompt`
    and a decode step per token of `feed`, at capacity WIN_CAPACITY.
    With `forced` (another run's result on the same prompt and feed),
    each routing call takes the choices that run made in the same call,
    its gates renormalised from its own probabilities; its own choices
    are recorded all the same."""
    from repro_torch.models import moe
    real_route, real_top_k = moe.route, moe.top_k
    queue = iter([c for _, step in forced for _, c in step]
                 if forced is not None else [])
    calls, own = [], []

    def top_k(probs, k):
        gates, idx = real_top_k(probs, k)
        own.append(idx)
        if forced is None:
            return gates, idx
        want = next(queue, None)
        check(want is not None and want.shape == idx.shape,
              f"the forced run has no routing call of shape "
              f"{tuple(idx.shape)} at call {len(own)}")
        gates = probs.gather(-1, want)
        return gates / gates.sum(dim=-1, keepdim=True), want

    def recording(xg, router, cfg, dtype):
        out = real_route(xg, router, cfg, dtype)
        calls.append((torch.einsum("ngd,de->nge", xg.float(),
                                   router.float()), own.pop()))
        return out
    moe.route, moe.top_k = recording, top_k
    try:
        lg, state = model.prefill(
            params, torch.as_tensor(prompt[None], device="cuda"),
            WIN_CAPACITY, cim=cim)
        steps = [(lg[0, -1].float(), list(calls))]
        for t in feed:
            calls.clear()
            lg, state = model.decode(
                params, torch.tensor([[t]], device="cuda"), state, cim=cim)
            steps.append((lg[0, -1].float(), list(calls)))
    finally:
        moe.route, moe.top_k = real_route, real_top_k
    check(next(queue, None) is None,
          "the forced run made more routing calls than this one")
    return steps


def routing_flips(torch, calls_a, calls_b):
    """The margins in run b of every token whose own top-k choices
    differ from run a's, over all routing calls: each the smallest gap
    between neighbours among its k + 1 largest router logits, over its
    largest |logit| (a routing near tie is a margin <= NEAR_TIE)."""
    check(len(calls_a) == len(calls_b),
          f"{len(calls_a)} routing calls against {len(calls_b)}")
    margins = []
    for (_, ia), (lb, ib) in zip(calls_a, calls_b):
        diff = (ia != ib).any(-1)
        if bool(diff.any()):
            k = ia.shape[-1]
            top = lb[diff].sort(dim=-1, descending=True).values[:, :k + 1]
            gap = (top[:, :-1] - top[:, 1:]).min(dim=-1).values
            margins += (gap / lb[diff].abs().amax(dim=-1)).tolist()
    return margins


def phase_moe(torch, np):
    """mixtral-8x7b at full width (SERVE_LAYERS): seeded random bf16 weights
    drawn and packed to base3 one layer at a time (init_packed), the
    bucket ServeEngine on 8 x 128 x MOE_NEW (counts zeroed just before
    and read just after: moe_forward_matmuls a forward, prefill on mma
    and decode on gemv, one transfer), the expert products' shapes in one
    prefill and one decode step, per-phase times beside the decode bytes
    floor and a profiled decode step; then the window run (the dense
    Scheduler on a 4160-token and a 4064-token prompt, 64 new each, at
    capacity 4224: the cache rolls at the window of 4096) and the
    cuda-vs-torch parity on the first PARITY_LAYERS layers of the same
    packed params."""
    from repro_torch.core.cim_linear import CIMConfig, hbm_bytes
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine
    cfg = serve_cfg(MOE_ARCH)
    model = registry.build(cfg)
    cim = CIMConfig(mode="ternary", packing="base3", domain="float")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t = time.monotonic()
    packed = model.init_packed(torch.Generator(device="cuda").manual_seed(0),
                               cim, device="cuda")
    torch.cuda.synchronize()
    init_pack_s = time.monotonic() - t
    init_peak = torch.cuda.max_memory_allocated()
    packed_bytes = hbm_bytes(packed)
    wbytes = packed_bytes - hbm_bytes(
        {k: v for k, v in packed.items() if k == "embed"})
    print("[moe] " + json.dumps(dict(
        arch=cfg.name, init_pack_s=init_pack_s, peak_bytes=init_peak,
        resident_before_bytes=resident,
        bf16_weight_bytes=model.param_bytes(),
        packed_weight_bytes=packed_bytes)))

    rng = np.random.default_rng(23)
    warm = ServeEngine(model, packed, capacity=CAPACITY, max_batch=BATCH,
                       cim=cim, device="cuda")
    for r in _requests(rng, cfg.vocab_size, BATCH):
        r.max_new = 2
        warm.submit(r)
    warm.run()
    del warm
    eng = ServeEngine(model, packed, capacity=CAPACITY, max_batch=BATCH,
                      cim=cim, device="cuda")
    check(eng.cim.backend == "cuda",
          f"{MOE_ARCH}: auto resolved to {eng.cim.backend!r} on the card")
    reqs = _requests(rng, cfg.vocab_size, BATCH)
    for r in reqs:
        r.max_new = MOE_NEW
        eng.submit(r)
    tm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = eng.run()
    wall = time.monotonic() - t0
    launches, routes = dict(tm.LAUNCHES), dict(tm.ROUTES)
    per_forward = moe_forward_matmuls(cfg)
    check(launches["ternary_matmul"] == per_forward * MOE_NEW
          and launches["ternary_matmul_int8"] == 0,
          f"{MOE_ARCH}: {launches} ternary launches, expected "
          f"{per_forward} a forward x {MOE_NEW} forwards")
    check(routes["mma"] > 0 and routes["gemv"] > 0
          and routes["cuda_core"] == 0,
          f"{MOE_ARCH}: prefill must take the mma route and decode the "
          f"gemv route, got {routes}")
    check(eng.host_transfers == 1,
          f"{MOE_ARCH}: {eng.host_transfers} host transfers for 1 bucket")
    check(len(done) == BATCH and all(
        len(r.out_tokens) == MOE_NEW
        and all(0 <= tok < cfg.padded_vocab for tok in r.out_tokens)
        for r in done), f"{MOE_ARCH}: a request is missing tokens")

    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             device="cuda")
    (logits, state), pre_shapes = matmul_shapes(
        torch, tm, lambda: model.prefill(packed, tokens, CAPACITY,
                                         cim=eng.cim))
    tok = logits[:, -1].argmax(-1, keepdim=True)
    _, dec_shapes = matmul_shapes(torch, tm, lambda: model.decode(
        packed, tok, state, cim=eng.cim))
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.num_layers
    g = BATCH * PROMPT
    cap = max(1, int(g * cfg.experts_per_token * cfg.moe_capacity_factor
                     / e))
    dec_cap = max(1, int(BATCH * cfg.experts_per_token
                         * cfg.moe_capacity_factor / e))
    for shapes, m, what in ((pre_shapes, cap, "prefill"),
                            (dec_shapes, dec_cap, "decode")):
        got = (shapes.get((m, d, f), 0), shapes.get((m, f, d), 0))
        check(got == (2 * e * L, e * L),
              f"{MOE_ARCH} {what}: expert products {got} at M={m}, "
              f"expected {(2 * e * L, e * L)}; all calls {shapes}")
    sms = tm._sm_count(torch.device("cuda"))
    w2_plan = tm.mma_plan(cap, f, d, sms, tm.MMA_FLOAT_CHAIN)
    check(w2_plan[1] > 1, f"w2's prefill products (K={f}) must split K: "
                          f"plan {w2_plan}")
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.monotonic()
        logits, state = model.prefill(packed, tokens, CAPACITY, cim=eng.cim)
        torch.cuda.synchronize()
        prefill_ms.append((time.monotonic() - t) * 1e3)
    check(bool(torch.isfinite(logits).all()), f"{MOE_ARCH}: non-finite "
                                               f"logits")
    step_ms, tok, state = decode_step_ms(
        torch, model, packed, logits[:, -1].argmax(-1, keepdim=True), state,
        eng.cim, MOE_NEW - 2)
    dec_prof = profile_kernels(torch, "moe", "decode", lambda:
                               model.decode(packed, tok, state, cim=eng.cim))
    pre_prof = profile_kernels(torch, "moe", "prefill", lambda:
                               model.prefill(packed, tokens, CAPACITY,
                                             cim=eng.cim))
    busy = dec_prof and dec_prof["device_busy_ms"]
    del state, logits, eng
    bucket = dict(
        requests=len(done), generated_tokens=sum(len(r.out_tokens)
                                                 for r in done),
        host_transfers=1, launches=launches, routes=routes,
        matmuls_per_forward=per_forward, wall_s=wall,
        tok_per_s=sum(len(r.out_tokens) for r in done) / wall,
        prefill_ms=statistics.median(prefill_ms), decode_step_ms=step_ms,
        decode_device_busy_ms=busy,
        decode_kernels=dec_prof and dec_prof["kernels"],
        decode_device_idle_share=(1.0 - busy / step_ms if busy else None),
        decode_profile=dec_prof, prefill_profile=pre_prof,
        decode_weight_bytes=wbytes,
        decode_step_bound_ms=wbytes / HBM_BYTES_PER_S * 1e3,
        expert_m=dict(prefill=cap, decode=dec_cap),
        w2_prefill_plan=list(w2_plan),
        matmul_shapes_prefill={str(k): v for k, v in pre_shapes.items()},
        matmul_shapes_decode={str(k): v for k, v in dec_shapes.items()})
    print("[moe bucket] " + json.dumps(bucket))
    halves = moe_expert_halves(torch, cfg, packed, cim)

    prompts = [np.random.default_rng(29 + i).integers(
        0, cfg.vocab_size, n).astype(np.int32)
        for i, n in enumerate(WIN_PROMPTS)]
    t = time.monotonic()
    _, st = model.prefill(packed, torch.as_tensor(prompts[0][None],
                                                  device="cuda"),
                          WIN_CAPACITY, cim=cim)
    torch.cuda.synchronize()
    long_prefill_ms = (time.monotonic() - t) * 1e3
    check(st["k"].shape[2] == cfg.sliding_window,
          f"the {WIN_PROMPTS[0]}-token prefill's cache holds "
          f"{st['k'].shape[2]} positions")
    del st
    # the window prefills' expert rows: a group of 1024 per started 1024
    # tokens at capacity 320, the kernel cases' larger M
    for n in WIN_PROMPTS:
        groups = -(-n // 1024)
        m = groups * max(1, int(1024 * cfg.experts_per_token
                                * cfg.moe_capacity_factor / e))
        (_, st), shapes = matmul_shapes(torch, tm, lambda: model.prefill(
            packed, torch.as_tensor(prompts[WIN_PROMPTS.index(n)][None],
                                    device="cuda"), WIN_CAPACITY, cim=cim))
        del st
        got = (shapes.get((m, d, f), 0), shapes.get((m, f, d), 0))
        check(m in MOE_MS and got == (2 * e * L, e * L),
              f"the {n}-token prefill: expert products {got} at M={m} "
              f"(kernel cases at {MOE_MS}); all calls {shapes}")
    window, _ = moe_window_run(torch, np, model, packed, cfg, cim, prompts,
                               "moe window")
    window["long_prefill_ms"] = long_prefill_ms
    cut_cfg, cut_params = cut_depth(cfg, packed, PARITY_LAYERS)
    parity = moe_parity(torch, np, cut_cfg, registry.build(cut_cfg),
                        cut_params, prompts)
    del cut_params, packed
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.num_layers, d_model=d,
                experts=e, experts_per_token=cfg.experts_per_token,
                d_ff=f, window=cfg.sliding_window, init_pack_s=init_pack_s,
                init_peak_bytes=init_peak,
                bf16_weight_bytes=model.param_bytes(),
                packed_weight_bytes=packed_bytes, bucket=bucket,
                window_run=window, parity=parity, launches=launches,
                expert_halves=halves)


def moe_expert_halves(torch, cfg, packed, cim):
    """Expert parallelism's join on one card: layer 0's MoE block with
    its experts computed in two halves (each half's products on every
    group's capacity rows, the unsplit M) and the outputs joined along
    E, bitwise ``moe_block``'s, at a prefill's (8 x 128) and a decode
    step's (8 x 1) rows.  Comparison launches: counted by no main-path
    read."""
    from repro_torch.models import moe
    wl = {k: v[0] for k, v in packed["blocks"].items()}
    e_l = cfg.num_experts // 2
    recs = []
    for s_len in (PROMPT, 1):
        g = torch.Generator(device="cuda").manual_seed(s_len)
        x = torch.randn(BATCH, s_len, cfg.d_model, generator=g,
                        device="cuda").to(cfg.dtype)
        want, _ = moe.moe_block(x, wl, cfg, cim)
        t = BATCH * s_len
        grp = min(moe.MOE_GROUP, t)
        pad = -t % grp
        xg = torch.nn.functional.pad(x.reshape(1, t, -1),
                                     (0, 0, 0, pad)).reshape(-1, grp,
                                                             cfg.d_model)
        dispatch, combine, _, _ = moe.route(xg, wl["router"], cfg, x.dtype)
        xe = torch.einsum("ngec,ngd->necd", dispatch, xg)
        ye = torch.cat([moe._experts(
            xe[:, h * e_l:(h + 1) * e_l].contiguous(),
            {k: wl[k][h * e_l:(h + 1) * e_l] for k in ("w1", "w2", "w3")},
            cim) for h in range(2)], dim=1)
        got = torch.einsum("ngec,necd->ngd", combine, ye).reshape(
            1, t + pad, -1)[:, :t].reshape(x.shape)
        rec = dict(rows=t, bitwise=bool(torch.equal(got, want)))
        print("[moe halves] " + json.dumps(rec))
        check(rec["bitwise"], f"{MOE_ARCH}: the experts in two halves, "
                              f"joined along E, differ from the block at "
                              f"{t} rows")
        recs.append(rec)
    return recs


def profile_kernels(torch, tag, what, fn, host=True):
    """One profiled call of `fn`: its device busy ms and kernels, the
    device ms and launches of ternary_matmul's kernels (``tm_*``) among
    them, by kernel, and the five kernels of most device time; None,
    with a line saying so, where the profiler recorded nothing (the
    profile is a reading only)."""
    try:
        per = device_kernels(torch, fn, host=host)
    except SmokeError as err:
        print(f"[{tag}] no {what} profile ({err})")
        return None
    tm = {}
    for key, (ms, n) in per.items():
        hit = re.search(r"\b(tm_\w+?)(<|\(|$)", key)
        if hit:
            ms0, n0 = tm.get(hit.group(1), (0.0, 0))
            tm[hit.group(1)] = (ms0 + ms, n0 + n)
    return dict(device_busy_ms=sum(ms for ms, _ in per.values()),
                kernels=sum(n for _, n in per.values()),
                ternary_matmul_ms=sum(ms for ms, _ in tm.values()),
                ternary_matmul_kernels=sum(n for _, n in tm.values()),
                ternary_matmul_by_kernel={k: list(v) for k, v in tm.items()},
                top_kernels=[[k[:80], ms, n] for k, (ms, n) in sorted(
                    per.items(), key=lambda kv: -kv[1][0])[:5]])


def decode_step_ms(torch, model, params, tok, state, cim, steps):
    """Host ms per decode step over `steps` steps (synchronized), the
    state after them and the last token."""
    torch.cuda.synchronize()
    t = time.monotonic()
    for _ in range(steps):
        logits, state = model.decode(params, tok, state, cim=cim)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits).all()), f"{model.cfg.name}: "
                                               f"non-finite logits")
    return (time.monotonic() - t) * 1e3 / steps, tok, state


def phase_int8_kv(torch, np, cfg, model, params):
    """internlm2-1.8b at full width with an int8 KV cache (base3/float,
    the weights the sched phase holds): quantize_kv on the card bitwise
    equal to the CPU's on one (L, SLOTS, SCHED_CAPACITY, KV, hd) bf16
    slab; the bucket engine on 8 x 128 + 32 at capacity 256 beside the
    float-KV run (equal prefill logits, one transfer, every token; the
    token agreement printed, not gated; decode ms/step of both); the
    dense Scheduler and the gather PagedScheduler with int8 KV on the
    bursty trace (gather tokens equal dense tokens, one transfer per
    chunk), fused_attn='auto' serving through the gather (no
    paged_attention launch, the same tokens) and fused_attn=True
    refused; the dense pools' bytes.  Each bucket run also times its
    prefill and decode step, profiles one decode step and reckons the
    decode floor (the packed weights and the KV the step reads and
    writes, at 3.35 TB/s)."""
    import dataclasses
    from repro_torch.core.cim_linear import CIMConfig, hbm_bytes
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import attention, registry
    from repro_torch.serve import PagedScheduler, Request, Scheduler, \
        ServeEngine
    cim = CIMConfig(mode="ternary", packing="base3", domain="float")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    model8 = registry.build(cfg8)
    out = dict(arch=cfg.name)

    gen = torch.Generator(device="cuda").manual_seed(31)
    slab = torch.randn((cfg.num_layers, SLOTS, SCHED_CAPACITY,
                        cfg.num_kv_heads, cfg.hd), generator=gen,
                       device="cuda", dtype=torch.bfloat16)
    q, sc = attention.quantize_kv(slab)
    qc, scc = attention.quantize_kv(slab.cpu())
    check(torch.equal(q.cpu(), qc) and torch.equal(sc.cpu(), scc),
          "quantize_kv on the card differs from the CPU's: codes "
          f"{int((q.cpu() != qc).sum())}, scales "
          f"{int((sc.cpu() != scc).sum())} differ")
    out["quantize_kv_slab"] = list(slab.shape)
    print("[int8-kv] quantize_kv: card == CPU, bitwise, on "
          f"{tuple(slab.shape)}")
    del slab, q, sc, qc, scc

    rng = np.random.default_rng(37)
    reqs = _requests(rng, cfg.vocab_size, BATCH)
    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             device="cuda")
    lf, _ = model.prefill(params, tokens, CAPACITY, cim=cim)
    l8, st8 = model8.prefill(params, tokens, CAPACITY, cim=cim)
    check(st8["k"].dtype == torch.int8 and "k_scale" in st8,
          "the int8 prefill state holds no codes and scales")
    check(torch.equal(lf, l8), "int8-KV prefill logits differ from the "
                               "float-KV run's")
    del st8
    wbytes = hbm_bytes(params) - hbm_bytes({"embed": params["embed"]})
    bucket, served = {}, {}
    for kv, m in (("float", model), ("int8", model8)):
        eng = ServeEngine(m, params, capacity=CAPACITY, max_batch=BATCH,
                          cim=cim, device="cuda")
        for r in reqs:
            eng.submit(Request(uid=r.uid, prompt=r.prompt, max_new=MAX_NEW))
        tm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        done = eng.run()
        wall = time.monotonic() - t0
        check(eng.host_transfers == 1,
              f"int8-kv bucket ({kv}): {eng.host_transfers} transfers")
        check(len(done) == BATCH and all(
            len(r.out_tokens) == MAX_NEW
            and all(0 <= t < cfg.padded_vocab for t in r.out_tokens)
            for r in done), f"int8-kv bucket ({kv}): a request is "
                            f"missing tokens")
        served[kv] = {r.uid: list(r.out_tokens) for r in done}
        launches = dict(tm.LAUNCHES)
        prefill_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.monotonic()
            logits, state = m.prefill(params, tokens, CAPACITY, cim=cim)
            torch.cuda.synchronize()
            prefill_ms.append((time.monotonic() - t) * 1e3)
        step_ms, tok, state = decode_step_ms(
            torch, m, params, logits[:, -1].argmax(-1, keepdim=True), state,
            cim, MAX_NEW - 2)
        prof = profile_kernels(torch, "int8-kv", f"{kv} decode", lambda:
                               m.decode(params, tok, state, cim=cim))
        busy = prof and prof["device_busy_ms"]
        # the floor: the packed weights, and the cache's positions so far
        # (the bucket's mean) read and one written, k and v, every layer
        per_pos = sum(t.element_size() * t[0, 0, 0].numel()
                      for name, t in state.items()
                      if name in ("k", "v", "k_scale", "v_scale"))
        kv_bytes = (cfg.num_layers * BATCH * per_pos
                    * (PROMPT + MAX_NEW // 2 + 1))
        del logits, state
        bucket[kv] = dict(
            wall_s=wall, tok_per_s=eng.generated_tokens / wall,
            prefill_ms=statistics.median(prefill_ms), decode_step_ms=step_ms,
            decode_device_busy_ms=busy,
            decode_kernels=prof and prof["kernels"],
            decode_device_idle_share=(1.0 - busy / step_ms if busy
                                      else None),
            decode_kv_bytes=kv_bytes,
            decode_step_bound_ms=(wbytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
            launches=launches)
    agree = sum(a == b for u in served["float"]
                for a, b in zip(served["float"][u], served["int8"][u]))
    bucket["token_agreement_with_float_kv"] = agree / (BATCH * MAX_NEW)
    out["bucket"] = bucket
    print("[int8-kv bucket] " + json.dumps(bucket))

    sched, sched_tokens = phase_sched(torch, np, cfg8, model8, params,
                                      kinds=("dense", "gather"),
                                      tag="int8-kv sched")
    specs = sched_requests(np, cfg, seed=21)
    auto = make_scheduler("fused", model8, params, cim)
    check(auto.attn_plan is None,
          f"fused_attn='auto' resolved {auto.attn_plan} for an int8 pool")
    for uid, prompt, max_new, arrival in specs:
        auto.submit(Request(uid=uid, prompt=prompt, max_new=max_new,
                            arrival_s=arrival))
    tm.reset_launches()
    pa.reset_launches()
    done = auto.run()
    check(pa.LAUNCHES["paged_attention"] == 0,
          f"fused_attn='auto' on an int8 pool launched paged_attention "
          f"{pa.LAUNCHES['paged_attention']} times")
    check(auto.host_transfers == auto.chunks_run,
          f"int8 'auto': {auto.host_transfers} transfers for "
          f"{auto.chunks_run} chunks")
    check({r.uid: [int(t) for t in r.out_tokens] for r in done}
          == sched_tokens["gather"], "int8 'auto' tokens differ from the "
                                     "gather run's")
    del auto
    try:
        PagedScheduler(model8, params, capacity=SCHED_CAPACITY, slots=SLOTS,
                       chunk=CHUNK, page_size=PAGE, cim=cim,
                       fused_attn=True, device="cuda")
    except ValueError as err:
        check("int8 KV pool" in str(err), f"fused_attn=True: {err}")
    else:
        raise SmokeError("fused_attn=True on an int8 pool was not refused")
    pool8 = sched["dense"]["kv_bytes_pool"]
    dense = Scheduler(model, params, capacity=SCHED_CAPACITY, slots=SLOTS,
                      chunk=CHUNK, cim=cim, device="cuda")
    pool = dense.kv_bytes()
    del dense
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    want8 = 2 * L * SLOTS * SCHED_CAPACITY * kv * (hd + 4)
    check(pool8 == want8 == 207_618_048,
          f"int8 dense pool {pool8} bytes, expected {want8}")
    check(pool == 2 * L * SLOTS * SCHED_CAPACITY * kv * hd * 2,
          f"float dense pool {pool} bytes")
    out.update(sched=sched, auto_declined=True, true_refused=True,
               kv_bytes_pool_int8=pool8, kv_bytes_pool_float=pool)
    print("[int8-kv] " + json.dumps(dict(
        kv_bytes_pool_int8=pool8, kv_bytes_pool_float=pool,
        sched_decode_ms_per_step={k: r["decode_ms_per_step"]
                                  for k, r in sched.items()})))
    return out


def recurrent_forward_matmuls(model):
    """Packed matmuls of one forward of a recurrent model: zamba2's two
    per Mamba2 layer (in_proj, out_proj), seven per shared-block
    invocation (wq, wk, wv, wo, w1, w3, w2); xlstm's six per mLSTM (up,
    wq, wk, wv, wif packed on the call, down) and three per sLSTM (wx,
    up1, up2); then the unembedding."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        return 2 * cfg.num_layers + 7 * model.n_groups + 1
    return (6 + 3) * model.n_pairs + 1


def recurrent_state_bytes(model, capacity):
    """{leaf: bytes} of one slot's decode state at `capacity`."""
    import math
    return {name: math.prod(spec.shape) * (
        spec.dtype or model.cfg.dtype).itemsize
        for name, spec in model.cache_specs(1, capacity).items()}


def recurrent_step_bytes(model, capacity, batch, positions):
    """Bytes one decode step must move besides the weights: every
    recurrent carry read and written, and of a KV cache the `positions`
    written so far read and one position written, for `batch` rows."""
    per = recurrent_state_bytes(model, capacity)
    total = 0
    for name, b in per.items():
        if name in ("k", "v"):
            total += b // capacity * (positions + 1)
        else:
            total += 2 * b
    return batch * total


def cut_recurrent(cfg, params, layers):
    """zamba2's first `layers` Mamba2 layers (views, every width kept):
    with attn_every 6, 7 layers make one shared-block invocation and a
    tail of one."""
    import dataclasses
    cut = {**params, "mamba_ln": params["mamba_ln"][:layers],
           "mamba": {k: v[:layers] for k, v in params["mamba"].items()}}
    return dataclasses.replace(cfg, num_layers=layers), cut


def recurrent_parity(torch, np, cfg, model, params, tag):
    """The cuda backend against the plain torch backend named
    explicitly: a prefill of 2 x PROMPT tokens and 4 decode steps fed the
    cuda run's tokens, every step's logits within MODEL_FLOAT_TOL of the
    logit scale; the worst step printed."""
    import dataclasses
    from repro_torch.core.cim_linear import CIMConfig
    rng = np.random.default_rng(41)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          size=(2, PROMPT)), device="cuda")
    base = CIMConfig(mode="ternary", packing="base3", domain="float")
    logits, feed = {}, None
    for backend in ("cuda", "torch"):
        cim = dataclasses.replace(base, backend=backend)
        lg, state = model.prefill(params, tokens, PROMPT + 8, cim=cim)
        steps = [lg.float()]
        if feed is None:
            feed = [lg[:, -1].argmax(-1, keepdim=True)]
        for i in range(4):
            lg, state = model.decode(params, feed[i], state, cim=cim)
            steps.append(lg.float())
            if len(feed) < 5:
                feed.append(lg[:, -1].argmax(-1, keepdim=True))
        logits[backend] = steps
        del state
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(logits["cuda"], logits["torch"])]
    worst = max(range(len(rel)), key=rel.__getitem__)
    agree = sum((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(logits["cuda"], logits["torch"])) / len(rel)
    rec = dict(layers=cfg.num_layers, steps=len(rel), rel_err=rel,
               worst_step=worst, worst_rel_err=rel[worst],
               argmax_agreement=agree, bar=MODEL_FLOAT_TOL)
    print(f"[{tag}] parity " + json.dumps(rec))
    check(rel[worst] <= MODEL_FLOAT_TOL,
          f"{cfg.name}: cuda vs torch logits {rel[worst]} of the scale at "
          f"step {worst}")
    return rec


def phase_recurrent(torch, np, arch):
    """One recurrent model at full width (SERVE_LAYERS), base3/float: the
    default packing predicate's faults named (the launcher refuses
    xlstm-125m --packed base3), the weights drawn and packed a layer at
    a time (init_packed) through the model's pack_predicate; the
    bucket engine on 8 x PROMPT + REC_NEW (counts zeroed just before and
    read just after: recurrent_forward_matmuls a forward, prefill on mma
    and decode on gemv, one transfer, every token), per-phase times, a
    profiled decode step and the decode floor (packed bytes plus the
    state moved a step); the dense Scheduler (REC_SLOTS slots, chunk
    REC_CHUNK, capacity REC_CAPACITY) on REC_PROMPTS (the 600-token one
    through the padded SSD chunks), REC_NEW new each: the launches, one
    transfer per chunk, every token; the PagedScheduler refused; the
    cuda-vs-torch parity (zamba2 on its first 7 layers)."""
    from repro_torch import configs
    from repro_torch.core.cim_linear import CIMConfig, hbm_bytes
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import registry
    from repro_torch.serve import PagedScheduler, Request, Scheduler, \
        ServeEngine
    tag = f"recurrent {arch}"
    cfg = serve_cfg(arch)
    model = registry.build(cfg)
    cim = CIMConfig(mode="ternary", packing="base3", domain="float")
    # the default predicate's faults, of the full-depth config: a stacked
    # norm packs at 64 layers or more
    faults = registry.build(configs.get(arch)).packing_faults()
    check(faults, f"{arch}: the default predicate packs no leaf read "
                  f"outside the matmuls")
    launcher = None
    if arch == "xlstm-125m":
        launcher = launch_serve.main(["--arch", arch, "--packed", "base3",
                                      "--requests", "2", "--prompt-len",
                                      "32", "--max-new", "8"])
        check(launcher["kept_float"] == ["slstm.wr"]
              and launcher["host_transfers"] == 1
              and launcher["generated_tokens"] == 16,
              f"the launcher's xlstm-125m --packed base3 run: {launcher}")
        print(f"[{tag} launcher] " + json.dumps(launcher))
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = time.monotonic()
    params = model.init_packed(gen, cim, device="cuda",
                               predicate=model.pack_predicate)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t
    packed_bytes = hbm_bytes(params)
    wbytes = packed_bytes - hbm_bytes({"embed": params["embed"]})
    capacity = PROMPT + REC_NEW
    state_slot = recurrent_state_bytes(model, capacity)
    step_bytes = recurrent_step_bytes(model, capacity, BATCH,
                                      PROMPT + REC_NEW // 2)
    info = dict(arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
                packing_faults=faults, init_pack_s=init_s,
                bf16_weight_bytes=model.param_bytes(),
                packed_weight_bytes=packed_bytes, weight_bytes_read=wbytes,
                state_bytes_per_slot=state_slot,
                state_bytes_per_step=step_bytes,
                decode_step_bound_ms=(wbytes + step_bytes)
                / HBM_BYTES_PER_S * 1e3)
    print(f"[{tag}] " + json.dumps(info))

    rng = np.random.default_rng(43)
    warm = ServeEngine(model, params, capacity=capacity, max_batch=BATCH,
                       cim=cim, device="cuda")
    for r in _requests(rng, cfg.vocab_size, BATCH):
        r.max_new = 2
        warm.submit(r)
    warm.run()
    del warm
    eng = ServeEngine(model, params, capacity=capacity, max_batch=BATCH,
                      cim=cim, device="cuda")
    check(eng.cim.backend == "cuda",
          f"{arch}: auto resolved to {eng.cim.backend!r} on the card")
    reqs = _requests(rng, cfg.vocab_size, BATCH)
    for r in reqs:
        r.max_new = REC_NEW
        eng.submit(r)
    tm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = eng.run()
    wall = time.monotonic() - t0
    launches, routes = dict(tm.LAUNCHES), dict(tm.ROUTES)
    per_forward = recurrent_forward_matmuls(model)
    check(launches["ternary_matmul"] == per_forward * REC_NEW
          and launches["ternary_matmul_int8"] == 0,
          f"{arch}: {launches} ternary launches, expected {per_forward} a "
          f"forward x {REC_NEW} forwards")
    # the prefill's unembedding reads the last position: M = 8, gemv
    check(routes["mma"] == per_forward - 1 and routes["cuda_core"] == 0
          and routes["gemv"] == per_forward * (REC_NEW - 1) + 1,
          f"{arch}: prefill must take the mma route and decode the gemv "
          f"route, got {routes}")
    check(eng.host_transfers == 1,
          f"{arch}: {eng.host_transfers} host transfers for 1 bucket")
    check(len(done) == BATCH and all(
        len(r.out_tokens) == REC_NEW
        and all(0 <= tok < cfg.padded_vocab for tok in r.out_tokens)
        for r in done), f"{arch}: a request is missing tokens")

    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             device="cuda")
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.monotonic()
        logits, state = model.prefill(params, tokens, capacity, cim=eng.cim)
        torch.cuda.synchronize()
        prefill_ms.append((time.monotonic() - t) * 1e3)
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    step_ms, tok, state = decode_step_ms(
        torch, model, params, logits[:, -1].argmax(-1, keepdim=True), state,
        eng.cim, REC_NEW - 2)
    dec_prof = profile_kernels(torch, tag, "decode", lambda: model.decode(
        params, tok, state, cim=eng.cim))
    busy = dec_prof and dec_prof["device_busy_ms"]
    del state, logits, eng
    bucket = dict(
        requests=len(done), generated_tokens=sum(len(r.out_tokens)
                                                 for r in done),
        host_transfers=1, launches=launches, routes=routes,
        matmuls_per_forward=per_forward, wall_s=wall,
        tok_per_s=sum(len(r.out_tokens) for r in done) / wall,
        prefill_ms=statistics.median(prefill_ms), decode_step_ms=step_ms,
        decode_device_busy_ms=busy,
        decode_kernels=dec_prof and dec_prof["kernels"],
        decode_device_idle_share=(1.0 - busy / step_ms if busy else None),
        decode_profile=dec_prof,
        decode_step_bound_ms=info["decode_step_bound_ms"])
    print(f"[{tag} bucket] " + json.dumps(bucket))

    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in REC_PROMPTS]
    sched = Scheduler(model, params, capacity=REC_CAPACITY, slots=REC_SLOTS,
                      chunk=REC_CHUNK, cim=cim, device="cuda")
    check(set(sched.pool) == set(model.cache_specs(1, 1)),
          f"{arch}: pool lanes {sorted(sched.pool)}")
    for i, p in enumerate(prompts):
        sched.submit(Request(uid=i, prompt=p, max_new=REC_NEW))
    tm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = sched.run()
    swall = time.monotonic() - t0
    slaunch = dict(tm.LAUNCHES)
    forwards = len(prompts) + sched.chunk * sched.chunks_run
    check(sched.host_transfers == sched.chunks_run,
          f"{arch} Scheduler: {sched.host_transfers} transfers for "
          f"{sched.chunks_run} chunks")
    check(slaunch["ternary_matmul"] == per_forward * forwards,
          f"{arch} Scheduler: {slaunch} launches, expected {per_forward} x "
          f"{forwards} forwards")
    check(len(done) == len(prompts) and all(
        len(r.out_tokens) == REC_NEW for r in done),
        f"{arch} Scheduler: a request is missing tokens")
    srec = dict(requests=len(done), prompts=REC_PROMPTS, slots=REC_SLOTS,
                chunk=REC_CHUNK, capacity=REC_CAPACITY,
                chunks=sched.chunks_run,
                host_transfers=sched.host_transfers, wall_s=swall,
                tok_per_s=sched.generated_tokens / swall,
                kv_bytes_pool=sched.kv_bytes(), launches=slaunch)
    del sched
    try:
        PagedScheduler(model, params, capacity=REC_CAPACITY, slots=REC_SLOTS,
                       chunk=REC_CHUNK, cim=cim, device="cuda")
    except ValueError as err:
        check("does not support paged KV" in str(err),
              f"{arch}: PagedScheduler refused with {err}")
    else:
        raise SmokeError(f"{arch}: the PagedScheduler was not refused")
    srec["paged_refused"] = True
    print(f"[{tag} sched] " + json.dumps(srec))

    if cfg.family == "hybrid":
        cut_cfg, cut_params = cut_recurrent(cfg, params, ZAMBA_PARITY_LAYERS)
        cut_model = registry.build(cut_cfg)
        check((cut_model.n_groups, cut_model.n_tail) == (1, 1),
              f"the cut zamba2: {cut_model.n_groups} groups, tail "
              f"{cut_model.n_tail}")
    else:
        cut_cfg, cut_params, cut_model = cfg, params, model
    parity = recurrent_parity(torch, np, cut_cfg, cut_model, cut_params, tag)
    del cut_params, params
    torch.cuda.empty_cache()
    return dict(info, bucket=bucket, sched=srec, parity=parity,
                launches=launches, launcher=launcher)


def cross_forward_matmuls(model):
    """Packed matmuls of one prefill and of one decode step: whisper's
    encoder six a layer (wq, wk, wv, wo, w1, w2), its cross keys and
    values two a decoder layer (x_wk, x_wv, prefill only) and its
    decoder eight (wq, wk, wv, wo, x_wq, x_wo, w1, w2); the VLM's seven
    a self layer, its cross blocks' keys and values two (prefill only)
    and q and o two; then the unembedding."""
    cfg = model.cfg
    if cfg.family == "audio":
        dec = 8 * cfg.num_layers + 1
        return 6 * cfg.encoder_layers + 2 * cfg.num_layers + dec, dec
    step = 7 * cfg.num_layers + 2 * model.n_cross + 1
    return step + 2 * model.n_cross, step


def cut_cross(cfg, params, layers):
    """The first `layers` layers (views, every width kept): whisper's
    first `layers` encoder and decoder layers; the VLM's first `layers`
    self layers and the cross blocks among them."""
    import dataclasses
    if cfg.family == "audio":
        cut = {**params,
               "enc_blocks": {k: v[:layers]
                              for k, v in params["enc_blocks"].items()},
               "dec_blocks": {k: v[:layers]
                              for k, v in params["dec_blocks"].items()}}
        return dataclasses.replace(cfg, num_layers=layers,
                                   encoder_layers=layers), cut
    n = layers // cfg.cross_attn_every
    cut = {**params,
           "blocks": {k: v[:layers] for k, v in params["blocks"].items()},
           "cross_blocks": {k: v[:n]
                            for k, v in params["cross_blocks"].items()}}
    return dataclasses.replace(cfg, num_layers=layers), cut


def cross_parity(torch, np, cfg, model, params, extra, key, packing, tag):
    """The cuda backend against the plain torch backend named
    explicitly on the cut model: a prefill of 2 x 32 tokens (with the
    phase's `extra` input) and 4 decode steps fed the cuda run's
    tokens, every step's logits within MODEL_FLOAT_TOL of the logit
    scale; the worst step printed."""
    import dataclasses
    from repro_torch.core.cim_linear import CIMConfig
    rng = np.random.default_rng(47)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 32)),
                             device="cuda")
    base = CIMConfig(mode="ternary", packing=packing, domain="float")
    logits, feed = {}, None
    for backend in ("cuda", "torch"):
        cim = dataclasses.replace(base, backend=backend)
        lg, state = model.prefill(params, tokens, 40, cim=cim,
                                  **{key: extra.expand(2, -1, -1)})
        steps = [lg.float()]
        if feed is None:
            feed = [lg[:, -1].argmax(-1, keepdim=True)]
        for i in range(4):
            lg, state = model.decode(params, feed[i], state, cim=cim)
            steps.append(lg.float())
            if len(feed) < 5:
                feed.append(lg[:, -1].argmax(-1, keepdim=True))
        logits[backend] = steps
        del state
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(logits["cuda"], logits["torch"])]
    worst = max(range(len(rel)), key=rel.__getitem__)
    agree = sum((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(logits["cuda"], logits["torch"])) / len(rel)
    rec = dict(layers=cfg.num_layers, encoder_layers=cfg.encoder_layers,
               steps=len(rel), rel_err=rel, worst_step=worst,
               worst_rel_err=rel[worst], argmax_agreement=agree,
               bar=MODEL_FLOAT_TOL)
    print(f"[{tag}] parity " + json.dumps(rec))
    check(rel[worst] <= MODEL_FLOAT_TOL,
          f"{cfg.name}: cuda vs torch logits {rel[worst]} of the scale at "
          f"step {worst}")
    return rec


def cross_launcher(arch, packing):
    """The launcher at full size: ``--arch <arch> --packed <packing>`` on
    2 requests of 32 tokens, 8 new each: one bucket, one transfer,
    every token; the leaves it keeps float."""
    from repro_torch.launch import serve as launch_serve
    out = launch_serve.main(["--arch", arch, "--packed", packing,
                             "--requests", "2", "--prompt-len", "32",
                             "--max-new", "8"])
    check(out["host_transfers"] == 1 and out["generated_tokens"] == 16
          and out["backend"] == "cuda",
          f"the launcher's {arch} --packed {packing} run: {out}")
    return {k: out[k] for k in ("packed", "backend", "kept_float",
                                "weight_bytes", "weight_bytes_served",
                                "generated_tokens", "host_transfers",
                                "wall_s", "tok_per_s")}


def phase_cross(torch, np, arch):
    """One cross-attending model at full width (SERVE_LAYERS; whisper-large-
    v3 base3/float, llama-3.2-vision-90b trit2/float), drawn and packed
    a layer at a time through its pack_predicate; seeded N(0, 1) bf16
    frames or patches, one tensor that extra_inputs expands to the
    batch; the VLM's gates seeded nonzero (init's zeros would hide the
    cross path).  The bucket engine (counts zeroed just before and read
    just after: the prefill's and each decode step's launches, prefill
    on mma but its unembedding, decode on gemv; one transfer; every
    token), encoder, prefill and decode times, a profiled decode step
    and the decode floor (the weights decode reads, the cross keys and
    values and the self KV, at 3.35 TB/s); the VLM's logits moving with
    the patches; the dense Scheduler (one transfer per chunk, every
    token, its launches) and the PagedScheduler's refusal; the
    cuda-vs-torch parity on the first layers; the launcher at full
    size."""
    from repro_torch import configs
    from repro_torch.core.cim_linear import CIMConfig, hbm_bytes
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import registry
    from repro_torch.serve import PagedScheduler, Request, Scheduler, \
        ServeEngine
    spec = CROSS[arch]
    tag = f"cross {arch}"
    cfg = serve_cfg(arch)
    model = registry.build(cfg)
    key = "frames" if cfg.family == "audio" else "patches"
    cim = CIMConfig(mode="ternary", packing=spec["packing"], domain="float")
    # the default predicate's faults, of the full-depth config (the
    # launcher's): a stacked norm packs at 64 layers or more
    faults = registry.build(configs.get(arch)).packing_faults()
    check(faults == spec["faults"],
          f"{arch}: the default predicate's faults {faults}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    params = model.init_packed(gen, cim, device="cuda",
                               predicate=model.pack_predicate)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t
    init_peak = torch.cuda.max_memory_allocated()
    if cfg.cross_attn_every:
        params["cross_blocks"]["gate"] = 0.5 + torch.rand(
            model.n_cross, generator=gen, device="cuda")
    stack = "blocks" if key == "patches" else "dec_blocks"
    check(all(isinstance(params[stack][n], torch.Tensor)
              for n in ("ln1", "ln2")), f"{arch}: a stacked norm was packed")
    extra = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=gen,
                        device="cuda").to(cfg.dtype)
    feed = {key: lambda b: extra.expand(b, -1, -1)}
    packed_bytes = hbm_bytes(params)
    dec_names = ("dec_blocks",) if key == "frames" else (
        "blocks", "cross_blocks")
    read = {n: params[n] for n in dec_names}
    read["unembed"] = params["unembed"]
    if key == "patches":          # decode reads no cross wk / wv
        read["cross_blocks"] = {k: v for k, v in read["cross_blocks"].items()
                                if k not in ("wk", "wv")}
    else:
        read["dec_blocks"] = {k: v for k, v in read["dec_blocks"].items()
                              if k not in ("x_wk", "x_wv")}
    wbytes = hbm_bytes(read)
    import math
    capacity, prompt, new = spec["capacity"], spec["prompt"], spec["new"]
    slot = {name: math.prod(s.shape) * (s.dtype or cfg.dtype).itemsize
            for name, s in model.cache_specs(1, capacity).items()}
    cross_slot = slot["xk"] + slot["xv"]
    pos = prompt + new // 2
    step_bytes = BATCH * (cross_slot + (slot["k"] + slot["v"]) // capacity
                          * (pos + 1))
    info = dict(arch=arch, layers=cfg.num_layers,
                encoder_layers=cfg.encoder_layers,
                cross_blocks=getattr(model, "n_cross", 0),
                d_model=cfg.d_model, packing=spec["packing"],
                packing_faults=faults, init_pack_s=init_s,
                init_peak_bytes=init_peak,
                bf16_weight_bytes=model.param_bytes(),
                packed_weight_bytes=packed_bytes,
                embed_bytes=hbm_bytes({"embed": params["embed"]}),
                weight_bytes_read_per_step=wbytes,
                cross_kv_bytes_per_slot=cross_slot,
                state_bytes_per_step=step_bytes,
                decode_step_bound_ms=(wbytes + step_bytes)
                / HBM_BYTES_PER_S * 1e3)
    check(cross_slot == spec["cross_slot"],
          f"{arch}: {cross_slot} cross K/V bytes a slot")
    print(f"[{tag}] " + json.dumps(info))

    rng = np.random.default_rng(53)

    def requests(n, max_new):
        return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   size=prompt),
                        max_new=max_new) for i in range(n)]
    warm = ServeEngine(model, params, capacity=capacity, max_batch=BATCH,
                       cim=cim, device="cuda", extra_inputs=feed)
    for r in requests(BATCH, 2):
        warm.submit(r)
    warm.run()
    del warm
    eng = ServeEngine(model, params, capacity=capacity, max_batch=BATCH,
                      cim=cim, device="cuda", extra_inputs=feed)
    check(eng.cim.backend == "cuda",
          f"{arch}: auto resolved to {eng.cim.backend!r} on the card")
    reqs = requests(BATCH, new)
    for r in reqs:
        eng.submit(r)
    tm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = eng.run()
    wall = time.monotonic() - t0
    launches, routes = dict(tm.LAUNCHES), dict(tm.ROUTES)
    per_prefill, per_step = cross_forward_matmuls(model)
    check(per_prefill == spec["per_prefill"] and per_step ==
          spec["per_step"], f"{arch}: {per_prefill} / {per_step} matmuls "
                            f"a prefill / decode step")
    check(launches["ternary_matmul"] == per_prefill + per_step * (new - 1)
          and launches["ternary_matmul_int8"] == 0,
          f"{arch}: {launches} ternary launches, expected {per_prefill} + "
          f"{per_step} x {new - 1}")
    # the prefill's unembedding reads the last position: M = 8, gemv
    check(routes["mma"] == per_prefill - 1 and routes["cuda_core"] == 0
          and routes["gemv"] == per_step * (new - 1) + 1,
          f"{arch}: prefill must take the mma route and decode the gemv "
          f"route, got {routes}")
    check(eng.host_transfers == 1,
          f"{arch}: {eng.host_transfers} host transfers for 1 bucket")
    check(len(done) == BATCH and all(
        len(r.out_tokens) == new
        and all(0 <= tok < cfg.padded_vocab for tok in r.out_tokens)
        for r in done), f"{arch}: a request is missing tokens")

    tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             device="cuda")
    batch_extra = {key: extra.expand(BATCH, -1, -1)}
    encoder_ms = None
    if key == "frames":
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.monotonic()
            model.encode(params, batch_extra[key], eng.cim_prefill)
            torch.cuda.synchronize()
            times.append((time.monotonic() - t) * 1e3)
        encoder_ms = statistics.median(times)
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.monotonic()
        logits, state = model.prefill(params, tokens, capacity,
                                      cim=eng.cim_prefill, **batch_extra)
        torch.cuda.synchronize()
        prefill_ms.append((time.monotonic() - t) * 1e3)
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    live = None
    if key == "patches":
        other = torch.randn(extra.shape, generator=gen,
                            device="cuda").to(cfg.dtype)
        a, _ = model.prefill(params, tokens[:1], capacity,
                             cim=eng.cim_prefill, patches=extra)
        b, _ = model.prefill(params, tokens[:1], capacity,
                             cim=eng.cim_prefill, patches=other)
        live = ((a.float() - b.float()).abs().max()
                / a.float().abs().max()).item()
        check(live > 0.01, f"{arch}: logits moved {live} of the scale "
                           f"with other patches")
    step_ms, tok, state = decode_step_ms(
        torch, model, params, logits[:, -1].argmax(-1, keepdim=True), state,
        eng.cim, new - 2)
    dec_prof = profile_kernels(torch, tag, "decode", lambda: model.decode(
        params, tok, state, cim=eng.cim))
    busy = dec_prof and dec_prof["device_busy_ms"]
    del state, logits, eng
    bucket = dict(
        requests=len(done), prompt=prompt, new=new, capacity=capacity,
        generated_tokens=sum(len(r.out_tokens) for r in done),
        host_transfers=1, launches=launches, routes=routes,
        matmuls_per_prefill=per_prefill, matmuls_per_step=per_step,
        wall_s=wall, tok_per_s=sum(len(r.out_tokens) for r in done) / wall,
        encoder_ms=encoder_ms, prefill_ms=statistics.median(prefill_ms),
        logits_moved_with_patches=live, decode_step_ms=step_ms,
        decode_device_busy_ms=busy,
        decode_kernels=dec_prof and dec_prof["kernels"],
        decode_device_idle_share=(1.0 - busy / step_ms if busy else None),
        decode_profile=dec_prof,
        decode_step_bound_ms=info["decode_step_bound_ms"])
    print(f"[{tag} bucket] " + json.dumps(bucket))

    sched = Scheduler(model, params, capacity=spec["sched_capacity"],
                      slots=CROSS_SLOTS, chunk=CROSS_CHUNK, cim=cim,
                      device="cuda", extra_inputs=feed)
    check(set(sched.pool) == {"k", "v", "xk", "xv"},
          f"{arch}: pool lanes {sorted(sched.pool)}")
    prompts = spec["sched_prompts"]
    for i, n in enumerate(prompts):
        sched.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                        size=n),
                             max_new=new))
    tm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = sched.run()
    swall = time.monotonic() - t0
    slaunch = dict(tm.LAUNCHES)
    want = per_prefill * len(prompts) + per_step * (sched.chunk
                                                    * sched.chunks_run)
    check(sched.host_transfers == sched.chunks_run,
          f"{arch} Scheduler: {sched.host_transfers} transfers for "
          f"{sched.chunks_run} chunks")
    check(slaunch["ternary_matmul"] == want,
          f"{arch} Scheduler: {slaunch} launches, expected {want}")
    check(len(done) == len(prompts) and all(
        len(r.out_tokens) == new for r in done),
        f"{arch} Scheduler: a request is missing tokens")
    srec = dict(requests=len(done), prompts=prompts, slots=CROSS_SLOTS,
                chunk=CROSS_CHUNK, capacity=spec["sched_capacity"],
                chunks=sched.chunks_run,
                host_transfers=sched.host_transfers, wall_s=swall,
                tok_per_s=sched.generated_tokens / swall,
                kv_bytes_pool=sched.kv_bytes(), launches=slaunch)
    del sched
    try:
        PagedScheduler(model, params, capacity=spec["sched_capacity"],
                       slots=CROSS_SLOTS, chunk=CROSS_CHUNK, cim=cim,
                       device="cuda", extra_inputs=feed)
    except ValueError as err:
        check("does not support paged KV" in str(err),
              f"{arch}: PagedScheduler refused with {err}")
    else:
        raise SmokeError(f"{arch}: the PagedScheduler was not refused")
    srec["paged_refused"] = True
    print(f"[{tag} sched] " + json.dumps(srec))

    cut_cfg, cut_params = cut_cross(cfg, params, spec["parity_layers"])
    parity = cross_parity(torch, np, cut_cfg, registry.build(cut_cfg),
                          cut_params, extra, key, spec["packing"], tag)
    del cut_params, params, read
    gc.collect()
    torch.cuda.empty_cache()
    launcher = cross_launcher(arch, spec["packing"])
    check(launcher["kept_float"] == faults,
          f"{arch}: the launcher kept {launcher['kept_float']} float")
    print(f"[{tag} launcher] " + json.dumps(launcher))
    torch.cuda.empty_cache()
    return dict(info, bucket=bucket, sched=srec, parity=parity,
                launcher=launcher, launches=launches)


def frontend_registry():
    """The front-end's two models at full width (SERVE_LAYERS), bf16,
    one paged pool each, built on their first request."""
    from repro_torch.frontend import ModelRegistry, ModelSpec
    reg = ModelRegistry(device="cuda")
    for name in FE_MODELS:
        reg.register(ModelSpec(
            name=name, arch=name, smoke=False, kind="paged",
            capacity=FE_CAPACITY, slots=FE_SLOTS, chunk=FE_CHUNK,
            page_size=FE_PAGE, dtype="bfloat16",
            overrides=(("num_layers", SERVE_LAYERS[name]),)
            if name in SERVE_LAYERS else ()))
    return reg


def meter_rounds(reg, pa):
    """Wrap every pool's round (the front-end's ``step_round`` and the
    direct ``run()`` both go through it): each round appends (model,
    seconds, paged_attention launches in it) to the returned list."""
    rounds = []
    for name in reg.names():
        sched = reg.entry(name).scheduler
        serve_round = sched._serve_round

        def timed(elapsed, serve_round=serve_round, name=name):
            n0, t = pa.LAUNCHES["paged_attention"], time.monotonic()
            serve_round(elapsed)    # ends in the round's one transfer
            rounds.append((name, time.monotonic() - t,
                           pa.LAUNCHES["paged_attention"] - n0))
        sched._serve_round = timed
    return rounds


def per_model(reg, streams, rounds, chunks0, transfers0, wall):
    """Per-model numbers of one replay: tokens, tok/s over the replay's
    wall (the pools share it, round-robin), TTFT and latency, chunks and
    transfers, rounds and paged_attention launches."""
    from repro_torch.serve import latency_stats, percentile
    out = {}
    for name in reg.names():
        sched = reg.entry(name).scheduler
        mine = [s for s in streams if s.model == name]
        ttft = sorted(s.ttft_s for s in mine)
        mr = [r for r in rounds if r[0] == name]
        tokens = sum(len(s.tokens) for s in mine)
        out[name] = dict(
            requests=len(mine), tokens=tokens, tok_per_s=tokens / wall,
            ttft_p50_s=percentile(ttft, 0.5), ttft_p99_s=percentile(
                ttft, 0.99), **latency_stats([s.req for s in mine]),
            chunks=sched.chunks_run - chunks0[name],
            host_transfers=sched.host_transfers - transfers0[name],
            rounds=len(mr), round_ms_median=statistics.median(
                r[1] for r in mr) * 1e3,
            decode_ms_per_step=sum(r[1] for r in mr) * 1e3
            / (len(mr) * sched.chunk),
            paged_attention_launches=sum(r[2] for r in mr),
            layers=reg.config(name).num_layers)
    return out


def profile_round(torch, sched):
    """One round of an idle pool (a chunk of decode steps of every slot
    and its one transfer): wall ms (median of 3) beside its device busy
    ms and kernels under torch.profiler."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.monotonic()
        sched.step_round(lambda: 0.0)
        walls.append((time.monotonic() - t) * 1e3)
    busy, kernels, _ = device_busy(torch,
                                   lambda: sched.step_round(lambda: 0.0))
    wall = statistics.median(walls)
    return dict(round_ms=wall, device_busy_ms=busy, kernels=kernels,
                device_idle_share=1.0 - busy / wall)


def fe_virtual_replay(reg, records, policy, tick, queue_limit):
    """One replay under a VirtualClock charging `tick` a busy poll; the
    report, the admission log, the virtual makespan and the wall s."""
    from repro_torch.frontend import FrontendServer, VirtualClock, replay
    clock = VirtualClock()
    server = FrontendServer(reg, policy, queue_limit=queue_limit,
                            clock=clock)
    t = time.monotonic()
    rep = replay(server, records, sleep=clock.advance,
                 tick=lambda: clock.advance(tick))
    return dict(report=rep, log=server.admission_log, makespan=clock(),
                wall_s=time.monotonic() - t)


def fe_overload(reg, records, tick):
    """The overload trace under a virtual clock whose tick is `tick` a
    round: the interactive deadline and the shedding floor are fractions
    of the parity records' virtual makespan (FIFO), so the outcome does
    not depend on the card's speed.  SLO admission twice (identical
    logs) and FIFO once."""
    from repro_torch.frontend import (FIFOAdmission, SLOAdmission,
                                      trace_requests)
    from repro_torch.serve import make_trace
    makespan = fe_virtual_replay(reg, records, FIFOAdmission(), tick,
                                 64)["makespan"]
    tight = round(FE_TIGHT * makespan, 4)
    floor = round(FE_FLOOR * makespan, 4)
    n_batch = FE_OVERLOAD - FE_INTERACTIVE
    trace = make_trace(
        [0.0] * FE_OVERLOAD,
        prompt_lens=[FE_BATCH[0]] * n_batch + [FE_INTER[0]] * FE_INTERACTIVE,
        max_news=[FE_BATCH[1]] * n_batch + [FE_INTER[1]] * FE_INTERACTIVE,
        priorities=[1] * n_batch + [0] * FE_INTERACTIVE,
        deadlines=[None] * n_batch + [tight] * FE_INTERACTIVE)
    over = trace_requests(trace, reg, list(FE_MODELS), seed=1)
    slo = [fe_virtual_replay(reg, over, SLOAdmission(service_floor_s=floor),
                             tick, FE_OVERLOAD) for _ in range(2)]
    fifo = fe_virtual_replay(reg, over, FIFOAdmission(), tick, FE_OVERLOAD)
    keys = ("tok_per_s_goodput", "tok_per_s", "goodput_tokens", "tokens",
            "deadline_met", "deadline_total", "shed", "wall_s",
            "ttft_p50_s", "ttft_p99_s", "p50_s", "p99_s", "p999_s",
            "mean_s", "queue_wait_mean_s", "queue_wait_p99_s",
            "service_mean_s", "service_p99_s", "host_transfers", "chunks")
    rec = dict(tick_s=tick, parity_makespan_s=makespan, tight_s=tight,
               service_floor_s=floor,
               slo={k: slo[0]["report"][k] for k in keys},
               fifo={k: fifo["report"][k] for k in keys},
               slo_wall_s=[r["wall_s"] for r in slo],
               fifo_wall_s=fifo["wall_s"],
               slo_logs_identical=slo[0]["log"] == slo[1]["log"])
    check(rec["slo_logs_identical"],
          "frontend: two SLO replays gave different admission logs")
    check(rec["slo"]["tok_per_s_goodput"] > rec["fifo"]["tok_per_s_goodput"],
          f"frontend: SLO goodput {rec['slo']['tok_per_s_goodput']} does "
          f"not beat FIFO's {rec['fifo']['tok_per_s_goodput']}")
    for r in slo + [fifo]:
        check(r["report"]["host_transfers"] == r["report"]["chunks"],
              "frontend: overload replay transfers != chunks")
    return rec


def fe_launcher():
    """The launcher in front-end mode on the card at full width
    (internlm2-1.8b only, f32 weights as its registry's default), its
    JSON line read back."""
    import contextlib
    import io
    from repro_torch.launch import serve as launch_serve
    buf = io.StringIO()
    t = time.monotonic()
    with contextlib.redirect_stdout(buf):
        out = launch_serve.main(FE_LAUNCHER_ARGS)
    wall = time.monotonic() - t
    check(out["host_transfers"] == out["chunks"] > 0,
          f"launcher --frontend: {out['host_transfers']} transfers for "
          f"{out['chunks']} chunks")
    check(out["completed"] == out["submitted"] == 8,
          f"launcher --frontend: {out['completed']} of {out['submitted']} "
          f"completed")
    keys = ("decode_loop", "models", "admission", "kv", "completed",
            "tokens", "tok_per_s", "tok_per_s_goodput", "deadline_met",
            "deadline_total", "ttft_p50_s", "ttft_p99_s", "p99_s",
            "host_transfers", "chunks", "wall_s")
    return dict({k: out[k] for k in keys}, process_wall_s=wall,
                capacity_report=out["capacity_report"])


def phase_frontend(torch, np):
    """The serving front-end over internlm2-1.8b and qwen3-14b at full
    width and depth (bf16 float weights, paged pools read through the
    paged_attention kernel) behind one FrontendServer: parity and
    streaming against replay_direct, backpressure, SLO vs FIFO admission
    under a virtual clock, and the launcher's front-end mode."""
    from repro_torch.frontend import (FIFOAdmission, FrontendServer,
                                      replay, replay_direct,
                                      trace_requests)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serve import make_trace
    torch.cuda.empty_cache()
    reg = frontend_registry()
    t = time.monotonic()
    for name in FE_MODELS:
        sched = reg.entry(name).scheduler
        check(sched.attn_plan is not None
              and sched.attn_plan.backend == "paged_attn",
              f"frontend {name}: attention plan {sched.attn_plan}")
    torch.cuda.synchronize()
    build_s = time.monotonic() - t
    records = trace_requests(
        make_trace([0.0] * FE_REQUESTS, FE_PROMPTS, FE_NEWS), reg,
        list(FE_MODELS), seed=0)
    rounds = meter_rounds(reg, pa)
    replay(FrontendServer(reg, FIFOAdmission()), records)      # warm-up

    # -- parity and streaming: the server against the direct pools
    server = FrontendServer(reg, FIFOAdmission())
    seen, submit = {}, server.submit

    def hooked(*a, **kw):
        return submit(*a, on_tokens=lambda s, new: seen.setdefault(
            s.uid, []).extend(new), **kw)
    server.submit = hooked
    live = {n: reg.entry(n).scheduler for n in FE_MODELS}
    chunks0 = {n: s.chunks_run for n, s in live.items()}
    transfers0 = {n: s.host_transfers for n, s in live.items()}
    del rounds[:]
    torch.cuda.synchronize()
    tm.reset_launches()
    pa.reset_launches()
    t = time.monotonic()
    rep = replay(server, records, collect_tokens=True)
    wall = time.monotonic() - t
    launches = {**tm.LAUNCHES, **pa.LAUNCHES}
    models = per_model(reg, server.completed, rounds, chunks0, transfers0,
                       wall)
    tick = statistics.median(r[1] for r in rounds)
    _, direct = replay_direct(reg, records)
    fe_tokens = [rep["out_tokens"][u] for u in sorted(rep["out_tokens"])]
    dt_tokens = [direct[r["uid"]] for r in records]
    check(rep["completed"] == FE_REQUESTS and all(
        len(t) == r["max_new"] for t, r in zip(fe_tokens, records)),
        "frontend: a request is missing tokens")
    check(fe_tokens == dt_tokens,
          "frontend: served tokens differ from replay_direct's")
    check(rep["host_transfers"] == rep["chunks"] > 0,
          f"frontend: {rep['host_transfers']} transfers for "
          f"{rep['chunks']} chunks")
    check(all(seen[s.uid] == s.tokens for s in server.completed),
          "frontend: on_tokens did not see each token once")
    check(launches["ternary_matmul"] == launches["ternary_matmul_int8"]
          == 0, f"frontend: float pools launched {launches}")
    total = 0
    for name, m in models.items():
        want = m["layers"] * FE_CHUNK * m["chunks"]
        check(m["paged_attention_launches"] == want,
              f"frontend {name}: paged_attention launched "
              f"{m['paged_attention_launches']} times, expected {want} "
              f"({m['layers']} layers x {FE_CHUNK * m['chunks']} steps)")
        total += want
    check(launches["paged_attention"] == total,
          f"frontend: paged_attention launched "
          f"{launches['paged_attention']} times, expected {total}")
    parity = dict(
        wall_s=wall, tick_s=tick, launches=launches, models=models,
        report={k: v for k, v in rep.items() if k != "out_tokens"},
        tokens_identical=True, transfers_eq_chunks=True)
    print("[frontend] parity " + json.dumps(parity))
    for name in FE_MODELS:
        models[name]["profiled_round"] = profile_round(torch, live[name])
        print(f"[frontend] {name} profiled round "
              + json.dumps(models[name]["profiled_round"]))

    # -- backpressure: the same records into a queue of 2
    bp_server = FrontendServer(reg, FIFOAdmission(), queue_limit=2)
    bp = replay(bp_server, records)
    check(bp["max_pending_seen"] <= 2 and bp_server.in_flight == 0
          and bp["submitted"] == bp["completed"] + bp["rejected"]
          and bp["rejects_by_reason"].get("queue-full", 0) > 0,
          f"frontend: backpressure {bp}")
    backpressure = {k: bp[k] for k in ("submitted", "completed", "rejected",
                                       "rejects_by_reason",
                                       "max_pending_seen")}
    print("[frontend] backpressure " + json.dumps(backpressure))

    # -- admission under overload, on a virtual clock
    overload = fe_overload(reg, records, tick)
    print("[frontend] overload " + json.dumps(overload))
    rec = dict(build_s=build_s, parity=parity, backpressure=backpressure,
               overload=overload, capacity_report=reg.capacity_report(),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    del reg, live, server, bp_server
    torch.cuda.empty_cache()

    # -- the launcher
    rec["launcher"] = fe_launcher()
    print("[frontend] launcher " + json.dumps(rec["launcher"]))
    return rec


def phase_long(torch, np, cfg, model, params):
    """Prompts past 2048 tokens on internlm2-1.8b at full width (base3,
    float domain): the bucket engine with LONG_BATCH prompts of
    LONG_PROMPT tokens (not a multiple of the flash chunk of 512); the
    PagedScheduler, gather and fused, with one SCHED_LONG_PROMPT-token
    request among short ones at capacity SCHED_LONG_CAPACITY; and one
    layer's flash recurrence held to the direct attention on the same
    q/k/v of FLASH_CHECK_T positions, in f32."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import attention
    from repro_torch.models.layers import rms_norm
    from repro_torch.serve import Request, ServeEngine
    cim = CIMConfig(mode="ternary", packing="base3", domain="float")
    rng = np.random.default_rng(31)
    out = {}
    # the flash recurrence against the direct attention, one layer
    x = params["embed"][torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(1, FLASH_CHECK_T)),
        device="cuda")].to(cfg.dtype)
    wl = {k: v[0] for k, v in params["blocks"].items()}
    q, k, v = attention._project_qkv(
        rms_norm(x, wl["ln1"], cfg.norm_eps), wl, cfg,
        torch.arange(FLASH_CHECK_T, device="cuda"), cim)
    q, k, v = q.float(), k.float(), v.float()
    check(FLASH_CHECK_T > attention.FLASH_THRESHOLD,
          "the flash check must sit above the threshold")
    flash = attention.flash_attention(q, k, v, cfg)
    direct = attention._gqa_attend(q, k, v, attention.causal_mask(
        FLASH_CHECK_T, FLASH_CHECK_T, device="cuda"))
    err = (flash - direct).abs().max().item()
    bar = FLASH_TOL * v.abs().max().item()
    out["flash_vs_direct"] = dict(positions=FLASH_CHECK_T, max_abs_err=err,
                                  bar=bar, v_scale=v.abs().max().item())
    print("[long] flash vs direct " + json.dumps(out["flash_vs_direct"]))
    check(err <= bar, f"flash_attention differs from the direct attention "
                      f"by {err} (> {bar})")
    del x, q, k, v, flash, direct

    # the bucket engine at 2 x 6000 prompt tokens
    prompts = [rng.integers(0, cfg.vocab_size, size=LONG_PROMPT)
               for _ in range(LONG_BATCH)]
    eng = ServeEngine(model, params, capacity=LONG_CAPACITY,
                      max_batch=LONG_BATCH, cim=cim, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new=LONG_NEW))
    tm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = eng.run()
    wall = time.monotonic() - t0
    launches = dict(tm.LAUNCHES)
    check(launches["ternary_matmul"] == forward_matmuls(cfg) * LONG_NEW,
          f"long bucket: {launches} ternary launches")
    check(eng.host_transfers == 1,
          f"long bucket: {eng.host_transfers} host transfers for 1 bucket")
    check(len(done) == LONG_BATCH and all(
        len(r.out_tokens) == LONG_NEW
        and all(0 <= tok < cfg.padded_vocab for tok in r.out_tokens)
        for r in done), "long bucket: a request is missing tokens")
    batch = torch.as_tensor(np.stack(prompts), device="cuda")
    prefill_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.monotonic()
        logits, _ = model.prefill(params, batch, LONG_CAPACITY, cim=eng.cim)
        torch.cuda.synchronize()
        prefill_ms.append((time.monotonic() - t) * 1e3)
    check(bool(torch.isfinite(logits).all()), "long prefill: non-finite")
    try:
        busy, kernels, _ = device_busy(torch, lambda: model.prefill(
            params, batch, LONG_CAPACITY, cim=eng.cim))
    except SmokeError as e:             # the profile is a reading only
        print(f"[long] no prefill profile ({e})")
        busy = kernels = None
    out["bucket"] = dict(
        requests=len(done), prompt=LONG_PROMPT, capacity=LONG_CAPACITY,
        generated_tokens=eng.generated_tokens,
        host_transfers=eng.host_transfers, wall_s=wall,
        tok_per_s=eng.generated_tokens / wall, launches=launches,
        prefill_ms=statistics.median(prefill_ms),
        prefill_tokens_per_s=LONG_BATCH * LONG_PROMPT
        / statistics.median(prefill_ms) * 1e3,
        prefill_device_busy_ms=busy, prefill_kernels=kernels)
    print("[long] bucket " + json.dumps(out["bucket"]))
    del eng, logits, batch
    torch.cuda.empty_cache()

    # the PagedScheduler with one 3000-token request among short ones
    specs = sched_requests(np, cfg, seed=23)[:SLOTS]
    long_prompt = rng.integers(0, cfg.vocab_size,
                               SCHED_LONG_PROMPT).astype(np.int32)
    uid, _, max_new, arrival = specs[0]
    specs[0] = (uid, long_prompt, max_new, arrival)
    runs, parity = phase_sched(torch, np, cfg, model, params, specs=specs,
                               kinds=("gather", "fused"),
                               capacity=SCHED_LONG_CAPACITY,
                               tag="long sched")
    one = torch.as_tensor(long_prompt[None], device="cuda")
    prefill_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.monotonic()
        model.prefill(params, one, SCHED_LONG_CAPACITY, cim=cim)
        torch.cuda.synchronize()
        prefill_ms.append((time.monotonic() - t) * 1e3)
    out["sched"] = runs
    out["sched_parity"] = parity
    out["sched_long_prefill_ms"] = statistics.median(prefill_ms)
    print("[long] sched " + json.dumps(dict(
        prompt=SCHED_LONG_PROMPT, capacity=SCHED_LONG_CAPACITY,
        long_prefill_ms=out["sched_long_prefill_ms"])))
    torch.cuda.empty_cache()
    return out


def fid_draw_cases(prng):
    """(name, key, draw shape, block) of the draw checks: flat ranges
    from 0, past 2^31 and past 2^32, one layer's planes of internlm2's
    stacked w1 (the disturb and scrub pieces) and the unembedding's
    column runs, as the device MAC's ADC noise draws them."""
    w1 = (5, 24, 2048, 8192)
    kn = 2048 * 8192
    return [("flat 2^20 from 0", prng.key(0), (1 << 33,),
             prng.flat_range(0, 1 << 20)),
            ("flat past 2^31", prng.key(7), (1 << 33,),
             prng.flat_range(2**31 - 1000, 1 << 20)),
            ("flat past 2^32", prng.key(2**31 - 1), (1 << 33,),
             prng.flat_range(2**32 + 17, 1 << 20)),
            ("w1 layer 7 planes", prng.fold_in(prng.key(3), 5), w1,
             prng.Block(7 * kn, 5, 24 * kn, kn)),
            ("noise runs", prng.key(11), (5, 5, 8, 128, 92672),
             prng.Block(3 * 8 * 128 * 92672 + 5000, 8 * 128, 92672, 4096))]


def threefry_record(ms, plain_ms, n):
    """Bound of a draw of n words: 4 bytes written each, ~73 int32
    operations each at the card's int32 rate."""
    from repro_torch.kernels import threefry
    t_bytes = 4 * n / HBM_BYTES_PER_S * 1e3
    t_ops = threefry.OPS_PER_WORD * n / INT32_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, words=n, bytes=4 * n,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                gbps=4 * n / ms / 1e6)


def phase_fidelity(torch, np, cfg, params, card, layer=True):
    """Device-fidelity serving (``repro_torch.faults``): the threefry
    kernel against its plain version, one full-width layer of the device
    MAC on the card against the CPU, then the dense Scheduler and the
    fused PagedScheduler under the launcher's campaign.  Every record
    printed carries the card's name and power limit."""
    import dataclasses
    from repro_torch import faults
    from repro_torch.core import prng
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.core.error_injection import expected_trit_error_rate
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.kernels import threefry
    from repro_torch.models import registry
    from repro_torch.serve import PagedScheduler, Request, Scheduler
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    out = {}

    # -- draws: the kernel bitwise against the plain version
    draws = []
    for name, key, shape, blk in fid_draw_cases(prng):
        got = prng.bits(key, shape, dev, blk)
        want = prng.bits_torch(key, blk, dev)
        check(torch.equal(got.reshape(want.shape), want),
              f"threefry differs from its plain version: {name}")
        if blk.rows * blk.cols <= 1 << 20:
            check(torch.equal(got.reshape(want.shape).cpu(),
                              prng.bits_torch(key, blk, "cpu")),
                  f"threefry on the card differs from the CPU: {name}")
        draws.append(dict(name=name, words=blk.rows * blk.cols))
    key, shape, blk = fid_draw_cases(prng)[3][1:]
    rec = threefry_record(
        time_ms(torch, lambda: threefry.random_bits(key, blk, dev), 5,
                flush),
        time_ms(torch, lambda: prng.bits_torch(key, blk, dev), 3, flush),
        blk.rows * blk.cols)
    rec.update(case="w1 layer planes (5 x 2048 x 8192)", max_abs_err=0,
               card=card)
    out["threefry"] = rec
    out["draw_cases"] = draws
    print("[fidelity] threefry " + json.dumps(rec))

    # -- one full-width w1 layer: the device MAC on the card vs the CPU
    # (a whole run has the parity worker hold it, beside the card)
    if layer:
        out["layer"] = fid_layer_cpu(torch, fid_layer_card(torch, np, cfg,
                                                           card))
    fm = faults.measured_fault_model(seed=0, drift_rate=0.001)

    # -- serving under the launcher's campaign, at FID_LAYERS of the depth
    faults.set_fault_model(fm)
    cfg, params = cut_depth(cfg, params, FID_LAYERS)
    model = registry.build(cfg)
    bound = 3.0 * expected_trit_error_rate(fm.restore_yield,
                                           (1 / 3, 1 / 3, 1 / 3))
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
               for _ in range(FID_REQUESTS)]
    exact_cim = CIMConfig(mode="ternary", packing="base3")
    dev_cim = dataclasses.replace(exact_cim, fidelity="device")
    runs = {}
    for kind in ("dense", "fused"):
        toks = {}
        for fid, cim in (("exact", exact_cim), ("device", dev_cim)):
            kw = dict(capacity=FID_CAPACITY, slots=FID_SLOTS,
                      chunk=FID_CHUNK, cim=cim, device="cuda",
                      scrub_every=FID_SCRUB_EVERY)
            torch.cuda.synchronize()
            t_init = time.monotonic()
            eng = (Scheduler(model, params, **kw) if kind == "dense" else
                   PagedScheduler(model, params, page_size=FID_PAGE,
                                  fused_attn="auto", **kw))
            torch.cuda.synchronize()
            init_s = time.monotonic() - t_init
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new=FID_NEW))
            tm.reset_launches()
            pa.reset_launches()
            threefry.reset_launches()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            done = eng.run()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = {**tm.LAUNCHES, **pa.LAUNCHES, **threefry.LAUNCHES}
            routes = dict(tm.ROUTES)
            toks[fid] = {r.uid: r.out_tokens for r in done}
            check(eng.host_transfers == eng.chunks_run,
                  f"{kind}/{fid}: {eng.host_transfers} transfers for "
                  f"{eng.chunks_run} chunks")
            check(len(done) == FID_REQUESTS and all(
                len(r.out_tokens) == FID_NEW for r in done),
                  f"{kind}/{fid}: a request is missing tokens")
            check(routes["mma"] > 0, f"{kind}/{fid}: prefill must take the "
                                     f"mma route, got {routes}")
            if kind == "fused":
                check(eng.attn_plan.backend == "paged_attn"
                      and launches["paged_attention"]
                      == cfg.num_layers * eng.chunk * eng.chunks_run,
                      f"{kind}/{fid}: {launches['paged_attention']} fused "
                      f"reads for {eng.chunks_run} chunks")
            if fid == "exact":
                continue
            check(eng.decode_per_slot == (kind == "dense"),
                  f"{kind}: decode_per_slot {eng.decode_per_slot}: the "
                  f"reference decodes the dense pool a slot per call and "
                  f"reads the fused pool in one call")
            check(eng.cim.backend == "device"
                  and eng.cim_prefill.backend == "cuda",
                  f"device run resolved decode {eng.cim.backend!r}, "
                  f"prefill {eng.cim_prefill.backend!r}")
            # a prefill's unembedding runs at M = 1 (its last position)
            # and takes gemv; device decode must add none
            check(routes["gemv"] == FID_REQUESTS,
                  f"{kind}: {routes['gemv']} gemv launches for "
                  f"{FID_REQUESTS} prefills: device decode took the gemv "
                  f"route")
            check(launches["threefry"] > 0, "threefry never launched")
            check(eng.scrubs_run >= 1, f"{kind}: no scrub ran")
            err = faults.packed_trit_error_rate(eng.params,
                                                eng._params_pristine)
            check(0.0 < err <= bound, f"{kind}: served trit error rate "
                                      f"{err} outside (0, {bound}]")
            rec = dict(kind=kind, wall_s=wall, init_s=init_s,
                       chunks=eng.chunks_run,
                       host_transfers=eng.host_transfers,
                       scrubs=eng.scrubs_run, adc_clip_lo=eng.adc_clip_lo,
                       adc_clip_hi=eng.adc_clip_hi, trit_error_rate=err,
                       trit_error_bound=bound, launches=launches,
                       routes=routes, card=card,
                       tok_per_s=eng.generated_tokens / wall)
            rec.update(fid_times(torch, np, eng, model, prompts[0]))
            runs[kind] = rec
        same = sum(a == b for u in toks["exact"] for a, b in
                   zip(toks["exact"][u], toks["device"][u]))
        runs[kind]["greedy_agreement"] = same / (FID_REQUESTS * FID_NEW)
        print(f"[fidelity] serve {kind} " + json.dumps(runs[kind]))
        del eng
        faults.model.clear_code_cache()
        torch.cuda.empty_cache()
    out["serve"] = runs
    return out


def fid_layer_card(torch, np, cfg, card):
    """Phase 8's device-MAC layer, the card's part: one full-width w1
    layer (2048 x 8192, M = 8) through device_ternary_mac on the card
    under measured_fault_model(seed=0, drift_rate=0.001), variation off,
    then on with ADC noise 0.5 (per_row), each timed; the inputs and
    outputs kept on the CPU for fid_layer_cpu."""
    import dataclasses
    from repro_torch import faults
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    fm = faults.measured_fault_model(seed=0, drift_rate=0.001)
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal(
        (8, cfg.d_model)).astype(np.float32))
    w = ops.pack_weights(torch.randn(
        (cfg.d_model, cfg.d_ff), generator=torch.Generator().manual_seed(4)),
        "base3")
    planes = faults.weight_trit_planes(w)
    xd, pd, sd = x.to(dev), planes.to(dev), w.scale.to(dev)
    runs = []
    for tag, model_f, per_row in (
            ("variation off", fm, False),
            ("variation on, adc noise 0.5",
             dataclasses.replace(fm, variation=True, adc_noise_sigma=0.5),
             True)):
        yd, lod, hid = faults.device_ternary_mac(
            xd, pd, sd, model_f, with_stats=True, per_row=per_row)
        ms = time_ms(torch, lambda: faults.device_ternary_mac(
            xd, pd, sd, model_f, per_row=per_row), 3, flush)
        runs.append(dict(tag=tag, model=model_f, per_row=per_row,
                         y=yd.cpu(), lo=int(lod), hi=int(hid), ms=ms))
    del xd, pd, sd, flush
    faults.model.clear_code_cache()
    torch.cuda.empty_cache()
    return dict(x=x, planes=planes, scale=w.scale, runs=runs, card=card)


def fid_layer_cpu(torch, job):
    """Phase 8's device-MAC layer, the CPU's part and the checks: bitwise
    with variation off; with variation on at most FID_VAR_SHARE of the
    outputs differ (f32 counts summed in another order)."""
    from repro_torch import faults
    layer = {}
    for run in job["runs"]:
        tag, model_f = run["tag"], run["model"]
        t = time.monotonic()
        yc, loc, hic = faults.device_ternary_mac(
            job["x"], job["planes"], job["scale"], model_f, with_stats=True,
            per_row=run["per_row"])
        cpu_s = time.monotonic() - t
        yd = run["y"]
        differ = float((yd != yc).float().mean())
        if model_f.variation:
            check(differ <= FID_VAR_SHARE,
                  f"device MAC ({tag}): {differ:.4f} of the outputs differ "
                  f"between the card and the CPU (bar {FID_VAR_SHARE})")
        else:
            check(torch.equal(yd, yc) and (run["lo"], run["hi"]) == (
                int(loc), int(hic)),
                  f"device MAC ({tag}) differs between the card and the CPU")
        layer[tag] = dict(share_differing=differ,
                          max_abs_err=float((yd - yc).abs().max()),
                          clip_lo=run["lo"], clip_hi=run["hi"],
                          card_ms=run["ms"], cpu_s=cpu_s,
                          per_row=run["per_row"], card=job["card"])
        print(f"[fidelity] layer {tag} " + json.dumps(layer[tag]),
              flush=True)
    faults.model.clear_code_cache()
    return layer


def fid_times(torch, np, eng, model, prompt):
    """ms of the device-fidelity pieces on the scheduler's served
    weights: the power-on restore (a scrub), one chunk's disturb, the ADC
    probe, one device decode step of every slot and one exact prefill."""
    from repro_torch import faults
    from repro_torch.core import prng

    def wall_ms(fn):
        # each piece already ran in the serve run: one timed call
        torch.cuda.synchronize()
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t) * 1e3

    def decode_step():
        # the dense decode, with the engine's rows per MAC call
        with faults.rows_as_calls(eng.decode_per_slot):
            model.decode(eng.params, tok, dict(state), cim=eng.cim)

    fm = eng._fault_model
    tokens = torch.as_tensor(prompt[None], device="cuda")
    state = model.init_cache(eng.slots, eng.capacity, torch.device("cuda"))
    state["pos"] = torch.full((eng.slots,), len(prompt), dtype=torch.int32,
                              device="cuda")
    tok = torch.zeros((eng.slots, 1), dtype=torch.int32, device="cuda")
    return dict(
        restore_ms=wall_ms(lambda: eng._restore(1)),
        disturb_ms=wall_ms(lambda: faults.disturb_packed_params(
            eng.params, fm.drift_rate, prng.fold_in(eng._drift_key, 99),
            num_trits=eng.cim.num_trits)),
        probe_ms=wall_ms(lambda: faults.adc_probe(eng.params)),
        decode_step_ms=wall_ms(decode_step),
        exact_prefill_ms=wall_ms(lambda: model.prefill(
            eng.params, tokens, eng.capacity, cim=eng.cim_prefill)))


def kernel_summary_threefry(fid, train, families):
    """The threefry kernel over one layer's planes of the stacked w1 (a
    disturb or scrub piece), with the launches of the device runs and of
    the train phase's data pipeline."""
    rec = fid["threefry"]
    return dict(
        name="threefry", route="cuda",
        source="src/repro_torch/csrc/threefry.cu",
        replaces=THREEFRY_REPLACES,
        replaces_note="not a Pallas kernel: XLA's threefry2x32 lowering of "
                      "the jax.random draws of the fault channels",
        launches=sum(r["launches"]["threefry"] for r in fid["serve"].values())
        + train["threefry_launches"] + families["threefry_launches"],
        launches_per_run={k: r["launches"]["threefry"]
                          for k, r in fid["serve"].items()},
        launches_train=dict(full=train["full"]["threefry_launches"],
                            launcher=train["launcher"]["threefry_launches"],
                            replay=train["replay"]["threefry_launches"]),
        launches_train_families={
            arch: r["threefry_launches"]
            for arch, r in families["families"].items()},
        train_families_draw=families["draw"],
        max_abs_err=0, ms=rec["ms"], plain_ms=rec["plain_ms"],
        bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
        library_ms=None,
        library_reason="no PyTorch call draws jax's threefry2x32 bits "
                       "(torch's generators are Philox)",
        workload=f"one draw of {rec['words']} words: one layer's five trit "
                 f"planes of internlm2-1.8b's stacked w1")


def kernel_summary_paged(paged, runs, models, long, frontend):
    fe = frontend["parity"]["launches"]["paged_attention"]
    return dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:96",
        launches=runs["fused"]["launches"]["paged_attention"] + fe,
        max_abs_err=paged["max_abs_err"], ms=paged["ms"],
        plain_ms=paged["plain_ms"], bound_ms=paged["bound_ms"],
        bound_by=paged["bound_by"], library_ms=None,
        library_reason=paged["library_reason"],
        bound_full_table_ms=paged["bound_full_table_ms"],
        device_ms=paged["device_ms"], load_route=paged["route"],
        plan=paged["plan"],
        ms_per_decode_step=paged["ms_per_step"],
        device_ms_per_decode_step=paged["device_ms_per_step"],
        other_cases={c["case"]: dict(ms=c["ms"], device_ms=c["device_ms"],
                                     bound_ms=c["bound_ms"])
                     for c in paged["cases"][1:]},
        launches_per_decode_step=runs["fused"]["launches"]["paged_attention"]
        // runs["fused"]["steps_launched"],
        launches_models={f"{arch} fused sched": m["sched"]["fused"][
            "launches"]["paged_attention"] for arch, m in models.items()
            if "sched" in m},
        launches_long_sched=long["sched"]["fused"]["launches"][
            "paged_attention"],
        launches_sched_fused=runs["fused"]["launches"]["paged_attention"],
        launches_frontend=fe,
        launches_frontend_models={
            name: m["paged_attention_launches"]
            for name, m in frontend["parity"]["models"].items()},
        workload="one layer's read at the serve shape: 8 slots x 8 KV heads "
                 "x 2 queries, hd 128, 32 pages of 16, bf16")


def trit_planes(torch, gen, shape, dev):
    return torch.randint(-1, 2, shape, generator=gen, device=dev,
                         dtype=torch.int8)


def planted_planes(torch, gen, qi, qw, m, k, n, dev, share):
    """Random trit planes with a `share` of the (row, full group) pairs
    planted to saturate: x_i's 16 trits all non-zero and, in one random
    column, w_j's their negation (mac = -16), for a random plane pair."""
    x = trit_planes(torch, gen, (qi, m, k), dev)
    w = trit_planes(torch, gen, (qw, k, n), dev)
    groups = k // 16
    plants = int(share * m * groups)
    if plants == 0:
        return x, w
    pick = torch.randperm(m * groups, generator=gen, device=dev)[:plants]
    rows, gs = pick // groups, pick % groups
    i = torch.randint(0, qi, (plants,), generator=gen, device=dev)
    j = torch.randint(0, qw, (plants,), generator=gen, device=dev)
    cols = torch.randint(0, n, (plants,), generator=gen, device=dev)
    signs = torch.randint(0, 2, (plants, 16), generator=gen, device=dev,
                          dtype=torch.int8) * 2 - 1
    ks = gs[:, None] * 16 + torch.arange(16, device=dev)
    x[i[:, None], rows[:, None], ks] = signs
    w[j[:, None], ks, cols[:, None]] = -signs
    return x, w


def cim_bytes_ops(qi, qw, m, k, n):
    """The groups route's work: bytes (the trit planes in once, the int32
    output out once) and operations (two per multiply-add of every plane
    pair)."""
    return qi * m * k + qw * k * n + 4 * m * n, 2 * qi * qw * m * k * n


def code_bytes_ops(m, k, n, cw):
    """The code route's work: bytes (the codes and base3 bytes in once,
    the weight's full-group lists, the int32 output) and operations (one
    int8 product)."""
    lists = 4 * cw.groups.offsets.numel() + 4 * cw.groups.entries.numel()
    return m * k + k * n + lists + 4 * m * n, 2 * m * k * n


def phase_cim_kernel(torch, cfg):
    """cim_mac vs its plain version, bitwise, through both routes and
    both entries; returns the per-shape records at the model's shapes."""
    from repro_torch.core.ternary import from_balanced_ternary
    from repro_torch.kernels import cim_mac as cm
    from repro_torch.kernels import ternary_matmul as tm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def routed_mac(fn, bits, what):
        before = dict(cm.ROUTES)
        out = fn()
        moved = [r for r in cm.ROUTES if cm.ROUTES[r] != before[r]]
        check(moved == [cm.route(bits)] and cm.route(bits) == (
            "codes" if bits >= 5 else "groups"),
              f"cim_mac {what} at {bits} bits took {moved}")
        return out

    ragged = [(5, 5, 8, 37, 131, 5), (5, 5, 1, 1000, 300, 5),
              (3, 5, 13, 1000, 67, 4), (1, 1, 9, 16, 3, 3),
              (5, 5, 70, 100, 259, 8), (5, 3, 2, 48, 513, 4),
              (5, 5, 1024, 200, 130, 3)]
    for qi, qw, m, k, n, bits in ragged:
        x = trit_planes(torch, gen, (qi, m, k), dev)
        w = trit_planes(torch, gen, (qw, k, n), dev)
        got = routed_mac(lambda: cm.cim_mac(x, w, bits), bits, "ragged")
        check(torch.equal(got, cm.cim_mac_torch(x, w, bits)),
              f"cim_mac {(qi, qw, m, k, n, bits)} is not bitwise")
    for bits in (4, 5):                        # every full group saturates
        x = torch.ones((5, 8, 2040), dtype=torch.int8, device=dev)
        w = -torch.ones((5, 2040, 300), dtype=torch.int8, device=dev)
        got = routed_mac(lambda: cm.cim_mac(x, w, bits), bits, "saturating")
        c = 2**bits - 1
        check(torch.equal(got, cm.cim_mac_torch(x, w, bits))
              and int(got[0, 0]) == (127 * (16 - c) + max(-8, 8 - c)) * 121**2,
              f"cim_mac all-saturating case at {bits} bits")
        if bits == 5:
            xc = from_balanced_ternary(x).to(torch.int8)
            check(torch.equal(routed_mac(lambda: cm.cim_mac_codes(
                xc, cm.code_weight(w), bits), bits, "saturating codes"), got),
                  "cim_mac_codes all-saturating case")
    # planted saturating groups: b = 5 adds the correction, 6 and 8 take
    # the product alone, 3 and 4 the groups route
    planted = []
    for qi, qw, m, k, n in ((5, 5, 8, 2048, 1024), (5, 5, 1024, 520, 136),
                            (5, 5, 1, 200, 130), (3, 5, 13, 1000, 67),
                            (5, 5, 8, 37, 5)):
        x, w = planted_planes(torch, gen, qi, qw, m, k, n, dev, 0.05)
        xc = from_balanced_ternary(x).to(torch.int8)
        cw = cm.code_weight(w)
        fired = int((cm.correction_torch(x, w, 5) != 0).sum())
        for bits in (3, 4, 5, 6, 8):
            want = cm.cim_mac_torch(x, w, bits)
            check(torch.equal(routed_mac(lambda: cm.cim_mac(x, w, bits),
                                         bits, "planted"), want),
                  f"cim_mac planted {(qi, qw, m, k, n, bits)} not bitwise")
            if bits >= 5:
                check(torch.equal(routed_mac(lambda: cm.cim_mac_codes(
                    xc, cw, bits), bits, "planted codes"), want),
                      f"cim_mac_codes planted {(m, k, n, bits)} not bitwise")
        planted.append(dict(shape=[qi, qw, m, k, n], saturated_outputs=fired,
                            listed_columns=int(cw.groups.entries.shape[0])))
    print("[cim-kernel] ragged, planted and saturating cases are bitwise "
          "equal, each through its route: " + json.dumps(planted))

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cases = []
    for name, k, n, per_forward in layer_shapes(cfg):
        w = trit_planes(torch, gen, (5, k, n), dev)
        cw = cm.code_weight(w)
        w_codes = (cw.data.to(torch.int16) - 121).to(torch.int8)
        for m in ((8,) if name == "unembed" else (8, BATCH * PROMPT)):
            x = trit_planes(torch, gen, (5, m, k), dev)
            xc = from_balanced_ternary(x).to(torch.int8)
            run = lambda: cm.cim_mac_codes(xc, cw)
            got = routed_mac(run, 5, "model shape")
            want = cm.cim_mac_codes_torch(xc, cw)
            planes_ok = torch.equal(cm.cim_mac(x, w), want)
            torch.cuda.synchronize()
            moved, ops = code_bytes_ops(m, k, n, cw)
            old_moved, old_ops = cim_bytes_ops(5, 5, m, k, n)
            product = torch.empty((m, n), dtype=torch.int32, device=dev)
            rec = dict(
                kernel="cim_mac", weight=name, m=m, k=k, n=n,
                per_forward=per_forward, route="codes",
                max_abs_err=(got - want).abs().max().item(),
                ok=bool(torch.equal(got, want) and planes_ok),
                listed_columns=int(cw.groups.entries.shape[0]),
                ms=time_ms(torch, run, 10, flush),
                product_ms=time_ms(torch, lambda: tm.launch_int32(
                    xc, cw.data, "base3", product), 10, flush),
                planes_entry_ms=time_ms(torch, lambda: cm.cim_mac(x, w), 5,
                                        flush),
                plain_ms=time_ms(torch, lambda: cm.cim_mac_codes_torch(
                    xc, cw), 2, flush),
                library_ms=None, bytes=moved, ops=ops,
                **bound(moved, ops, "int8"), old_bytes=old_moved,
                old_ops=old_ops,
                old_bound_ms=bound(old_moved, old_ops, "int8")["bound_ms"])
            if m > 16:
                # the product term alone (no clip): a yardstick only
                rec["int_mm_product_ms"] = time_ms(
                    torch, lambda: torch._int_mm(xc, w_codes), 10, flush)
            else:
                # the groups route (b = 4), timed beside the code route
                rec["groups_b4_ms"] = time_ms(
                    torch, lambda: cm.cim_mac(x, w, 4), 10, flush)
            rec.update(rate(rec))
            cases.append(rec)
            print("[cim-kernel] " + json.dumps(rec))
            check(rec["ok"], f"cim_mac disagrees with its plain version: "
                             f"{rec}")
            del x, xc, got, want, product
        del w, cw, w_codes
    return cases


def exact_split_ms(torch, cfg, params, cim_cases, flush):
    """Device ms of one exact-mode decode step's parts, each timed per
    weight shape and multiplied by its count: quantizing every dense()
    input to codes, and cim_mac's code entry; beside it what the cuda
    backend's weight cache pays once, at the first forward (ternarize,
    base3 bytes and full-group lists of every weight)."""
    from repro_torch.core.ternary import quantize_8b_truncate_5t
    from repro_torch.kernels import backends
    blocks = params["blocks"]
    weights = {"wq,wo": blocks["wq"][0], "wk,wv": blocks["wk"][0],
               "w1,w3": blocks["w1"][0], "w2": blocks["w2"][0],
               "unembed": params["unembed"]}
    gen = torch.Generator(device="cuda").manual_seed(5)
    split = dict(encode_ms=0.0, kernel_ms=0.0, ternarize_fill_ms=0.0)
    for name, k, n, per_forward in layer_shapes(cfg):
        w = weights[name]
        x = torch.randn((BATCH, k), generator=gen, device="cuda",
                        dtype=cfg.dtype)
        split["ternarize_fill_ms"] += per_forward * time_ms(
            torch, lambda: backends.CodeWeightCache().get(w, 5), 2, flush)
        split["encode_ms"] += per_forward * time_ms(
            torch, lambda: quantize_8b_truncate_5t(x).values.to(torch.int8),
            5, flush)
        split["kernel_ms"] += per_forward * next(
            c["ms"] for c in cim_cases if c["weight"] == name and c["m"] == 8)
    return split


def phase_exact(torch, np, cfg, model, params, cim_cases):
    """Macro-exact serving at full width, then cuda-vs-torch logits."""
    import dataclasses
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.kernels import backends
    from repro_torch.kernels import cim_mac as cm
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serve import Request, ServeEngine
    per_forward = sum(c[3] for c in layer_shapes(cfg))
    cache = backends.CODE_WEIGHTS
    cache.clear()
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, size=PROMPT)
               for _ in range(BATCH)]
    tokens, rec = {}, {}
    for mode in ("exact", "float"):
        cim = CIMConfig(mode="exact") if mode == "exact" else None
        eng = ServeEngine(model, params, capacity=CAPACITY, max_batch=BATCH,
                          cim=cim, device="cuda")
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new=EXACT_NEW))
        torch.cuda.synchronize()
        cm.reset_launches()
        tm.reset_launches()
        fills = cache.fills
        t0 = time.monotonic()
        done = eng.run()
        wall = time.monotonic() - t0
        launches = {**cm.LAUNCHES, **tm.LAUNCHES}
        routes = dict(cm.ROUTES)
        fills = cache.fills - fills
        tokens[mode] = {r.uid: [int(t) for t in r.out_tokens] for r in done}
        check(eng.host_transfers == 1,
              f"{mode}: {eng.host_transfers} host transfers for 1 bucket")
        check(len(done) == BATCH and all(
            len(r.out_tokens) == EXACT_NEW
            and all(0 <= t < cfg.padded_vocab for t in r.out_tokens)
            for r in done), f"{mode}: a request is missing tokens")
        if mode == "exact":
            check(eng.cim.backend == "cuda",
                  f"exact mode resolved {eng.cim.backend!r} on the card")
            # the prefill and the loop's max_new - 1 decode steps, all
            # with a live row (steps_run counts the prefill too)
            forwards = 1 + (EXACT_NEW - 1)
            check(eng.steps_run == forwards,
                  f"steps_run {eng.steps_run}, expected {forwards}")
            check(launches["cim_mac"] == per_forward * forwards,
                  f"cim_mac launched {launches['cim_mac']} times, expected "
                  f"{per_forward} x {forwards}")
            check(routes["codes"] == per_forward * forwards
                  and routes["groups"] == 0,
                  f"cim_mac routes {routes}, expected {per_forward} x "
                  f"{forwards} codes")
            # every weight is a distinct tensor, ternarized once
            check(fills == per_forward,
                  f"{fills} weights ternarized in the exact run, expected "
                  f"{per_forward}, one each")
            check(launches["ternary_matmul"] == 0
                  and launches["ternary_matmul_int8"] == 0,
                  f"a ternary kernel launched in exact mode: {launches}")
            rec.update(requests=len(done),
                       generated_tokens=eng.generated_tokens,
                       steps=eng.steps_run,
                       host_transfers=eng.host_transfers,
                       launches=launches, routes=routes,
                       weights_ternarized=fills, wall_s=wall,
                       tok_per_s=eng.generated_tokens / wall)
        else:
            rec["float_tok_per_s"] = eng.generated_tokens / wall
        del eng
    total = BATCH * EXACT_NEW
    rec["greedy_agreement_with_float"] = sum(
        a == b for u in tokens["exact"]
        for a, b in zip(tokens["exact"][u], tokens["float"][u])) / total

    cim = CIMConfig(mode="exact", backend="cuda")
    batch = torch.as_tensor(np.stack(prompts), device="cuda")
    # the first forward fills the weight cache, a later one finds it
    for key in ("prefill_first_ms", "prefill_ms"):
        if key == "prefill_first_ms":
            cache.clear()
        torch.cuda.synchronize()
        t = time.monotonic()
        logits, state = model.prefill(params, batch, CAPACITY, cim=cim)
        torch.cuda.synchronize()
        rec[key] = (time.monotonic() - t) * 1e3
    check(bool(torch.isfinite(logits).all()), "non-finite exact logits")
    tok = logits[:, -1].argmax(-1, keepdim=True)
    steps = 4
    fills = cache.fills
    torch.cuda.synchronize()
    t = time.monotonic()
    for _ in range(steps):
        logits, state = model.decode(params, tok, state, cim=cim)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    rec["decode_step_ms"] = (time.monotonic() - t) * 1e3 / steps
    check(cache.fills == fills,
          f"{cache.fills - fills} weights ternarized in decode steps after "
          f"the first forward")
    busy, launched, _ = device_busy(torch, lambda: model.decode(
        params, tok, state, cim=cim))
    rec.update(decode_device_busy_ms=busy, decode_kernels=launched,
               decode_idle_share=1 - busy / rec["decode_step_ms"])
    del state
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    split = exact_split_ms(torch, cfg, params, cim_cases, flush)
    split["ternarize_ms"] = 0.0     # no weight made in the steps (above)
    rec["decode_step_device_ms"] = split
    del flush

    # cuda backend vs the plain torch backend: bitwise logits
    small = torch.as_tensor(np.stack(prompts[:2]), device="cuda")
    logits = {}
    for backend in ("cuda", "torch"):
        cim_b = dataclasses.replace(cim, backend=backend)
        torch.cuda.synchronize()
        t = time.monotonic()
        lg, state = model.prefill(params, small, CAPACITY, cim=cim_b)
        out = [lg]
        for _ in range(2):
            lg, state = model.decode(params, lg[:, -1].argmax(
                -1, keepdim=True), state, cim=cim_b)
            out.append(lg)
        torch.cuda.synchronize()
        rec[f"parity_{backend}_s"] = time.monotonic() - t
        logits[backend] = torch.stack([o.float() for o in out])
        del state
    a, b = logits["cuda"], logits["torch"]
    rec["parity"] = dict(bitwise=bool(torch.equal(a, b)),
                         max_abs_err=(a - b).abs().max().item(),
                         logit_scale=b.abs().max().item())
    print("[exact] " + json.dumps(rec))
    check(rec["parity"]["bitwise"],
          f"exact-mode logits differ between cuda and torch: "
          f"{rec['parity']}")
    return rec


def kernel_summary_cim(cases, exact, cfg, train):
    """cim_mac over one exact-mode decode step (M = 8, every weight at its
    multiplicity) and one prefill, with the launches of the exact serve
    run, the bound of the code route beside the 25-pair bound of the
    groups route, and the groups route at b = 4 for continuity."""
    step = [c for c in cases if c["m"] == 8]
    prefill = [c for c in cases if c["m"] > 8 or c["weight"] == "unembed"]

    def total(recs, key):
        return sum(c[key] * c["per_forward"] for c in recs)
    return dict(
        name="cim_mac", route="cuda", source="src/repro_torch/csrc/cim_mac.cu",
        sources=["src/repro_torch/csrc/cim_mac.cu",
                 "src/repro_torch/csrc/ternary_matmul.cu"],
        replaces="src/repro/kernels/cim_mac.py:29",
        launches=exact["launches"]["cim_mac"] + train["cim_mac_launches"],
        launches_serve=exact["launches"]["cim_mac"],
        launches_train=train["cim_mac_launches"], routes=exact["routes"],
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=total(step, "ms"), plain_ms=total(step, "plain_ms"),
        **bound(total(step, "bytes"), total(step, "ops"), "int8"),
        old_bound_ms=bound(total(step, "old_bytes"), total(step, "old_ops"),
                           "int8")["bound_ms"],
        product_ms=total(step, "product_ms"),
        planes_entry_ms=total(step, "planes_entry_ms"),
        groups_b4_ms=total(step, "groups_b4_ms"),
        library_ms=None,
        library_reason="no PyTorch call clips each 16-row group's MAC "
                       "before the shift-and-add; prefill_int_mm_product_ms "
                       "times torch._int_mm on the codes, the product term "
                       "alone, as a yardstick",
        prefill_ms=total(prefill, "ms"),
        prefill_product_ms=total(prefill, "product_ms"),
        prefill_planes_entry_ms=total(prefill, "planes_entry_ms"),
        prefill_plain_ms=total(prefill, "plain_ms"),
        prefill_bound_ms=bound(total(prefill, "bytes"), total(prefill, "ops"),
                               "int8")["bound_ms"],
        prefill_old_bound_ms=bound(total(prefill, "old_bytes"),
                                   total(prefill, "old_ops"),
                                   "int8")["bound_ms"],
        prefill_int_mm_product_ms=sum(
            c["int_mm_product_ms"] * c["per_forward"] for c in prefill
            if "int_mm_product_ms" in c),
        launches_per_forward=sum(c["per_forward"] for c in step),
        workload=f"one exact-mode decode step of {cfg.name}: "
                 f"{sum(c['per_forward'] for c in step)} MACs of 5-trit codes "
                 f"at M=8, 5-bit ADC; prefill_* at M={BATCH * PROMPT} (the "
                 f"unembedding at M=8)")


def train_rows(model, path, b, s):
    """Rows a matmul weight multiplies in one forward of b x s tokens:
    the encoder's weights and the cross keys and values take the frames
    or patches, zamba2's shared block runs once a group."""
    cfg = model.cfg
    if path[0] == "enc_blocks" or path[-1] in ("x_wk", "x_wv") or (
            path[0] == "cross_blocks" and path[-1] in ("wk", "wv")):
        return b * cfg.encoder_seq
    if path[0] in ("shared_attn", "shared_mlp"):
        return b * s * model.n_groups
    return b * s


def train_model_flops(model, b, s):
    """6 x each matmul weight's size x the rows it multiplies (PERF.md
    section 2's count, with frames, patches and the shared block's reuse
    counted)."""
    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), v
    return 6 * sum(math.prod(spec.shape) * train_rows(model, path, b, s)
                   for path, spec in walk(model.param_specs)
                   if model.matmul_leaf(path))


def optimizer_bytes(model, optimizer):
    """Bytes the optimizer and the clip must move a step at bf16 params
    and grads, in the fewest passes.  AdamW: the grads read for the norm
    and again by an update that applies the clip (4), the params read
    and written (4), each f32 moment read and written (16).  Adafactor:
    the grads twice and the params twice (8), its factored moments too
    small to count."""
    return {"adamw": 24, "adafactor": 8}[optimizer] * model.param_count()


def step_ops(torch, fn):
    """The operations of the matmuls of one call of ``fn`` (aten mm,
    addmm, bmm and baddbmm, 2 m n k each; its backward pass and the remat
    re-forward included), by the rate the function needs: {"bf16": ..,
    "f32": .., "unplaced": ..}.  A product counts at the f32 rate only
    where the reference holds its inputs in f32: f32 inputs in
    ``models/ssm.py`` (the SSD chunk, the mLSTM and sLSTM cells).  Every
    other counts at the bf16 tensor-core rate: the weights' products,
    and attention's, whose inputs the reference keeps in bf16 with f32
    sums (the port upcasts them).  The embedding gradient's one-hot
    products (``layers.embed_grad``) do not count: the function sums
    rows there.  A product is placed by the innermost frame of
    ``repro_torch/models`` on the Python stack; in the backward pass, by
    a mark that the forward left on the autograd nodes made by calls
    from ``models/ssm.py``.  One placed by neither counts by its dtype,
    and under "unplaced" as well."""
    import os
    import sys
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    models = "repro_torch/models/"
    ssm = models + "ssm.py"
    inside_torch = os.path.dirname(torch.__file__) + os.sep
    marked = set()

    def mm(a, b):
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]

    def bmm(a, b):
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    rules = {aten.mm: (0, lambda a: mm(a[0], a[1])),
             aten.addmm: (1, lambda a: mm(a[1], a[2])),
             aten.bmm: (0, lambda a: bmm(a[0], a[1])),
             aten.baddbmm: (1, lambda a: bmm(a[1], a[2]))}
    counts = {"bf16": 0, "f32": 0, "unplaced": 0}

    def tensors(xs):
        for x in xs:
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, (list, tuple)):
                yield from tensors(x)

    class Mark(TorchFunctionMode):
        """Marks the nodes a torch call from models/ssm.py adds to the
        graph: those between its outputs and its inputs."""
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            f = sys._getframe(1)
            while f is not None and f.f_code.co_filename.startswith(
                    inside_torch):
                f = f.f_back
            if f is not None and f.f_code.co_filename.endswith(ssm):
                stop = {x.grad_fn for x in tensors(args)}
                todo = [x.grad_fn for x in tensors(
                    out if isinstance(out, (list, tuple)) else [out])]
                while todo:
                    node = todo.pop()
                    if node is None or node in stop or node in marked:
                        continue
                    marked.add(node)
                    todo.extend(n for n, _ in node.next_functions)
            return out

    def site():
        f = sys._getframe(2)
        while f is not None:
            if models in f.f_code.co_filename:
                return (f.f_code.co_filename.rsplit(models, 1)[1],
                        f.f_code.co_name)
            f = f.f_back
        node = torch._C._current_autograd_node()
        if node is None:
            return None
        return ("ssm.py", "") if node in marked else ("", "")

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            rule = rules.get(func.overloadpacket)
            if rule is not None:
                ops = rule[1](args)
                f32 = args[rule[0]].dtype == torch.float32
                where = site()
                if where is None:
                    counts["unplaced"] += ops
                    counts["f32" if f32 else "bf16"] += ops
                elif where != ("layers.py", "embed_grad"):
                    counts["f32" if f32 and where[0] == "ssm.py"
                           else "bf16"] += ops
            return func(*args, **(kwargs or {}))
    with Mark(), Count():
        fn()
    marked.clear()
    return counts


def train_bound(torch, model, ops, optimizer):
    """(bound ms, its compute ms, its optimizer ms): step_ops' products at
    989 TFLOP/s (bf16) and 67 (f32), plus optimizer_bytes at 3.35 TB/s."""
    compute_ms = (ops["bf16"] / PEAK_OPS_PER_S["float"]
                  + ops["f32"] / PEAK_F32_OPS_PER_S) * 1e3
    bytes_ms = optimizer_bytes(model, optimizer) / HBM_BYTES_PER_S * 1e3
    return compute_ms + bytes_ms, compute_ms, bytes_ms


def check_train_draws(torch, cfg, data, step, where):
    """The data pipeline's card draws at the training shapes, outside the
    counted runs: one 257-word block of a row's four draws through the
    threefry kernel bitwise against its plain version on the card and on
    the CPU, then the whole batch of ``step`` (frames or patches
    included) bitwise the CPU's."""
    from repro_torch.core import prng
    from repro_torch.data import batch_for
    n = data.seq_len + 1
    row = prng.fold_in(prng.fold_in(prng.key(data.seed), step), 0)
    for k in prng.split(row, 4):
        got = prng.bits(k, (n,), "cuda")
        check(torch.equal(got, prng.bits_torch(
            k, prng.flat_range(0, n), "cuda").reshape(n)) and torch.equal(
            got.cpu(), prng.bits(k, (n,), "cpu")),
            f"{where}: threefry differs from its plain version on a "
            f"{n}-word block of the pipeline")
    got = batch_for(cfg, data, step, device="cuda")
    want = batch_for(cfg, data, step, device="cpu")
    check(all(torch.equal(got[k].cpu(), want[k]) for k in want),
          f"{where}: the card's batch of step {step} differs from the CPU's")


def train_optimizer(spec, schedule=True):
    """The run's optimizer: its peak lr under the launcher's
    warmup_cosine(lr, max(steps // 20, 5), steps), or held constant."""
    from repro_torch import optim
    lr = spec.get("lr", TRAIN_LR)
    if schedule:
        lr = optim.warmup_cosine(lr, max(spec["steps"] // 20, 5),
                                 spec["steps"])
    return {"adamw": optim.adamw, "adafactor": optim.adafactor}[
        spec["optimizer"]](lr)


def train_run(torch, np, arch, card):
    """One run of TRAIN_RUNS (see there) at full width from model.init on
    the card, TRAIN_BATCH x TRAIN_SEQ tokens a step from batch_for
    through make_train_step, the counts zeroed just before the steps and
    read just after.  With ``twice``, one batch's loss and grads are
    first computed twice and held bitwise equal.  Checks: every loss and
    grad norm finite, the mean of the last ``fall`` losses below the
    first; the step's data on the card against the CPU
    (check_train_draws); threefry launched 6 times a row and once a step
    for the frames or patches.  Prints the step ms (median, min, max of
    steps 2 on), tokens/s, mfu, the bound (train_bound), peak bytes, the
    idle share and top kernels of one step profiled with device activity
    only, and the threefry launches a step."""
    from repro_torch import tree
    from repro_torch.data import DataConfig, batch_for
    from repro_torch.kernels import threefry
    from repro_torch.models import registry
    from repro_torch.train import (init_state, make_train_step,
                                   value_and_grad)
    spec = TRAIN_RUNS[arch]
    steps = spec["steps"]
    cfg = train_cfg(arch, spec.get("layers"))
    check(cfg.dtype == torch.bfloat16, f"{arch}: dtype {cfg.dtype}")
    model = registry.build(cfg)
    opt = train_optimizer(spec)
    t = time.monotonic()
    state = init_state(model, opt, torch.Generator(
        device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    same = None
    if spec.get("twice"):
        batch = batch_for(cfg, data, 0, device="cuda")
        runs = [value_and_grad(model, state.params, batch) for _ in range(2)]
        same = bool(torch.equal(runs[0][0], runs[1][0])) and all(
            torch.equal(a, b) for a, b in zip(tree.leaves(runs[0][1]),
                                              tree.leaves(runs[1][1])))
        check(same, f"{arch}: full-width loss and grads of one batch differ "
                    f"between two runs")
        del runs, batch
        gc.collect()
        torch.cuda.empty_cache()
    step_fn = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    threefry.reset_launches()
    hist, times = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t = time.monotonic()
        batch = batch_for(cfg, data, step, device="cuda")
        state, m = step_fn(state, batch)
        hist.append(torch.stack([m[k].to(torch.float32) for k in (
            "loss", "grad_norm", "lr")]).tolist())    # the one transfer
        torch.cuda.synchronize()
        times.append((time.monotonic() - t) * 1e3)
    launches = threefry.LAUNCHES["threefry"]
    peak = torch.cuda.max_memory_allocated()
    losses = [h[0] for h in hist]
    split = {"steps_s": sum(times) / 1e3}
    print(f"[train] {arch} losses {losses} grad norms "
          f"{[h[1] for h in hist]}")
    check(all(np.isfinite(h).all() for h in hist),
          f"{arch}: non-finite training metrics: {hist}")
    check(statistics.mean(losses[-spec["fall"]:]) < losses[0],
          f"{arch}: the loss did not fall: {losses}")
    t = time.monotonic()
    check_train_draws(torch, cfg, data, steps - 1, f"train {arch}")
    split["draw_check_s"] = time.monotonic() - t
    extra = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    steady = times[1:]
    step_ms = statistics.median(steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch = batch_for(cfg, data, steps, device="cuda")
    t = time.monotonic()
    ops = step_ops(torch, lambda: value_and_grad(model, state.params,
                                                  batch))
    split["step_ops_s"] = time.monotonic() - t
    model_flops = train_model_flops(model, TRAIN_BATCH, TRAIN_SEQ)
    bound_ms, compute_ms, bytes_ms = train_bound(torch, model, ops,
                                                 spec["optimizer"])
    t = time.monotonic()
    prof = profile_kernels(torch, "train", f"{arch} step",
                           lambda: step_fn(state, batch), host=False)
    split["profile_s"] = time.monotonic() - t
    busy = prof["device_busy_ms"] if prof else None
    rec = dict(
        arch=arch, family=cfg.family, layers=cfg.num_layers,
        encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
        dtype=str(cfg.dtype), remat=cfg.remat, optimizer=spec["optimizer"],
        peak_lr=spec.get("lr", TRAIN_LR), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        extra_input=extra, extra_shape=[TRAIN_BATCH, cfg.encoder_seq,
                                        cfg.d_model] if extra else None,
        steps=steps, params=model.param_count(), init_s=init_s,
        deterministic_grads=same, losses=losses,
        grad_norms=[h[1] for h in hist], lrs=[h[2] for h in hist],
        step_ms=times, step_ms_median=step_ms, step_ms_min=min(steady),
        step_ms_max=max(steady), first_step_ms=times[0],
        tokens_per_s=tokens / step_ms * 1e3, model_flops=model_flops,
        step_ops=ops,
        mfu=model_flops / (step_ms * 1e-3 * PEAK_OPS_PER_S["float"]),
        bound_ms=bound_ms, bound_compute_ms=compute_ms,
        bound_optimizer_bytes_ms=bytes_ms,
        optimizer_bytes=optimizer_bytes(model, spec["optimizer"]),
        peak_bytes=peak, threefry_launches=launches,
        threefry_launches_per_step=launches / steps,
        device_busy_ms=busy,
        device_idle_share=(1.0 - busy / step_ms if busy else None),
        top_kernels=prof["top_kernels"] if prof else None,
        profiled_kernels=prof["kernels"] if prof else None, seconds=split,
        card=card)
    print("[train] run " + json.dumps({k: v for k, v in rec.items()
                                       if k != "step_ms"}))
    check(launches == steps * (6 * TRAIN_BATCH + (1 if extra else 0)),
          f"{arch}: {launches} threefry launches in {steps} steps")
    del state, step_fn, batch
    return rec


def train_cfg(arch, layers=None):
    """The arch's full-width config, cut to ``layers`` where given
    (whisper: its encoder too)."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get(arch)
    if layers is None:
        return cfg
    cut = dict(num_layers=layers)
    if cfg.family == "audio":
        cut["encoder_layers"] = layers
    return dataclasses.replace(cfg, **cut)


def serve_cfg(arch):
    """The arch's full-width config at its SERVE_LAYERS depth."""
    return train_cfg(arch, SERVE_LAYERS.get(arch))


def train_parity(torch, np, arch):
    """(c) The arch cut to 2 layers (whisper: 2 encoder and 2 decoder
    blocks; the VLM one group of 2 self layers and its cross block;
    zamba2 one group of 6 Mamba2 layers and the shared block), every
    width kept, f32: one step of its run's optimizer at its peak lr on
    the card and on the CPU's plain path from the same params and batch,
    with ``optimizers.PIECE`` cut to PARITY_PIECE in both, so that the
    stacked leaves take the sliced norm, clip and update the full-size
    runs take.  Loss, grad norm and every moment (AdamW's two, or
    Adafactor's factored rows, columns and unfactored) within
    TRAIN_PARITY_TOL (relative; each moment of its leaf's max).  A first
    step moves each weight by about +/- lr (AdamW: lr g / (|g| + eps);
    Adafactor: lr g over its factored RMS, RMS-clipped), so the two
    updates are held within 1e-3 of lr but for the run's ``share`` of
    the weights (those whose AdamW gradient is of eps's size, where
    g / (|g| + eps) turns on any difference), and all within 2 lr.
    The card's part (parity_card) and the CPU's (parity_cpu) may run
    apart in time: a whole run has the parity worker run them."""
    return parity_cpu(torch, np, parity_offload(
        torch, parity_card(torch, np, arch)))


def parity_step(torch, model, spec, p, batch, dev):
    """One step of ``spec``'s optimizer (unscheduled, PARITY_PIECE) from
    params ``p`` on ``dev``: its seconds, metrics, and the params and
    moments after it (on ``dev``)."""
    from repro_torch import tree
    from repro_torch.optim import optimizers
    from repro_torch.train import TrainState, make_train_step
    piece = optimizers.PIECE
    optimizers.PIECE = PARITY_PIECE
    try:
        opt = train_optimizer(spec, schedule=False)
        state = TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=dev))
        t = time.monotonic()
        new, m = make_train_step(model, opt)(
            state, {k: v.to(dev) for k, v in batch.items()})
        m = {k: float(v) for k, v in m.items()}
        if dev == "cuda":
            torch.cuda.synchronize()
        s = time.monotonic() - t
        del state
        return dict(s=s, metrics=m, params=tree.leaves(new.params),
                    moments=tree.leaves(new.opt_state))
    finally:
        optimizers.PIECE = piece


def parity_card(torch, np, arch):
    """train_parity's card part: the cut's params drawn on the card, a
    copy of them for the CPU's step, the batch, and the card's step; the
    copy and the step's results stay on the card (parity_offload moves
    them)."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.data import DataConfig, batch_for
    from repro_torch.models import registry
    spec = TRAIN_RUNS[arch]
    cfg = train_cfg(arch)
    cut = dict(num_layers=2)
    if cfg.family == "audio":
        cut["encoder_layers"] = 2
    if cfg.family == "vlm":
        cut["cross_attn_every"] = 2
    if cfg.family == "hybrid":
        cut["num_layers"] = cfg.attn_every
    cfg = dataclasses.replace(cfg, dtype=torch.float32, **cut)
    model = registry.build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1),
                        "cuda")
    if "cross_blocks" in params:
        params["cross_blocks"]["gate"].fill_(0.5)
    sliced = sum(x.dim() >= 3 and x.numel() > PARITY_PIECE
                 for x in tree.leaves(params))
    rows, seq = spec["parity"]
    batch = batch_for(cfg, DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=rows,
                                      seed=2), 0, device="cuda")
    # the card's step on its params; the CPU's on `start`, in place
    start = tree.map_leaves(lambda x: x.clone(), params)
    g = parity_step(torch, model, spec, params, batch, "cuda")
    del params
    return dict(arch=arch, spec=spec, cut=cut, model=model, start=start,
                batch={k: v.cpu() for k, v in batch.items()},
                sliced=sliced, rows=rows, seq=seq, card=g)


def parity_offload(torch, job):
    """Move a card part's params copy and results to the CPU, freeing
    the card; returns ``job``."""
    from repro_torch import tree
    job["start"] = tree.map_leaves(lambda x: x.cpu(), job["start"])
    g = job["card"]
    g["params"] = [x.cpu() for x in g["params"]]
    g["moments"] = [x.cpu() for x in g["moments"]]
    gc.collect()
    torch.cuda.empty_cache()
    return job


def parity_cpu(torch, np, job):
    """train_parity's CPU part: the CPU's step from ``job``'s start and
    the checks against the card's."""
    arch, spec, model = job["arch"], job["spec"], job["model"]
    lr = spec.get("lr", TRAIN_LR)
    g = job.pop("card")
    c = parity_step(torch, model, spec, job.pop("start"), job["batch"],
                    "cpu")
    rel = {k: abs(g["metrics"][k] - c["metrics"][k]) / abs(c["metrics"][k])
           for k in ("loss", "grad_norm")}
    mom = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(g["moments"], c["moments"]))
    # both steps began at the same params: the updates differ by the
    # difference of the params after them
    past = total = 0
    worst = 0.0
    for a, b in zip(g["params"], c["params"]):
        d = (a - b).abs()
        past += int((d > 1e-3 * lr).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    share = past / total
    sliced = job["sliced"]
    rec = dict(arch=arch, cut=job["cut"], optimizer=spec["optimizer"],
               lr=lr, params=model.param_count(), sliced_leaves=sliced,
               piece=PARITY_PIECE, rows=job["rows"], seq=job["seq"],
               loss_cuda=g["metrics"]["loss"], loss_cpu=c["metrics"]["loss"],
               grad_norm_cuda=g["metrics"]["grad_norm"],
               grad_norm_cpu=c["metrics"]["grad_norm"],
               loss_rel_err=rel["loss"], grad_norm_rel_err=rel["grad_norm"],
               moments_rel_err=mom, update_share_past_1e3_lr=share,
               update_max_abs_err=worst, update_max_abs_err_over_lr=worst
               / lr, cuda_s=g["s"], cpu_s=c["s"])
    print("[train] parity " + json.dumps(rec), flush=True)
    check(sliced > 0, f"{arch}: no leaf took the sliced optimizer path")
    check(np.isfinite(g["metrics"]["grad_norm"])
          and rel["loss"] <= TRAIN_PARITY_TOL
          and rel["grad_norm"] <= TRAIN_PARITY_TOL
          and mom <= TRAIN_PARITY_TOL,
          f"{arch}: card vs CPU training step: {rec}")
    check(share <= spec.get("share", 1e-3) and worst <= 2 * lr,
          f"{arch}: card vs CPU param updates: {rec}")
    return rec


def train_launcher(torch, np):
    """(b) The launcher at full width with Adafactor into a temporary
    checkpoint directory, removed after: its JSON line, and the final
    forced save at step TRAIN_LAUNCHER_STEPS."""
    import os
    import shutil
    import tempfile
    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.kernels import threefry
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        threefry.reset_launches()
        t = time.monotonic()
        out = launch_train.main(["--arch", TRAIN_ARCH, "--optimizer",
                                 "adafactor", "--steps",
                                 str(TRAIN_LAUNCHER_STEPS), "--ckpt-dir",
                                 tmp])
        wall = time.monotonic() - t
        final = Path(tmp) / f"step_{TRAIN_LAUNCHER_STEPS:08d}"
        ckpt_bytes = sum(f.stat().st_size for f in final.iterdir())
        check(out["steps"] == TRAIN_LAUNCHER_STEPS and out["restarts"] == 0
              and all(np.isfinite(out[k]) for k in ("first_loss",
                                                    "last_loss")),
              f"the launcher's adafactor run: {out}")
        check((final / "manifest.json").exists() and not os.path.exists(
            str(final) + ".tmp"), f"no complete checkpoint in {final}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = dict(**out, call_s=wall, checkpoint_bytes=ckpt_bytes,
               threefry_launches=threefry.LAUNCHES["threefry"])
    # the launcher's data: its default batch, sequence and seed
    cfg = configs.get(TRAIN_ARCH)
    check_train_draws(torch, cfg, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0), TRAIN_LAUNCHER_STEPS - 1,
        "train launcher")
    print("[train] launcher " + json.dumps(rec))
    return rec


def train_replay(torch):
    """(d) The Trainer at smoke width (bf16; TRAIN_BATCH x TRAIN_SEQ
    tokens, so each step's embedding gradient sums many repeated
    tokens) with crashes before two updates and one in the middle of a
    save: final params and optimizer state bitwise equal to an
    uninterrupted run's."""
    import shutil
    import tempfile
    from repro_torch import configs, optim, tree
    from repro_torch.data import DataConfig
    from repro_torch.kernels import threefry
    from repro_torch.models import registry
    from repro_torch.train import FailurePlan, Trainer, TrainerConfig
    cfg = configs.smoke(TRAIN_ARCH)
    model = registry.build(cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_replay_"))
    threefry.reset_launches()
    try:
        runs = {}
        for name, plan in (("straight", None), ("crashed", FailurePlan(
                crash_at=TRAIN_REPLAY["crash_at"],
                crash_in_save=TRAIN_REPLAY["crash_in_save"]))):
            tc = TrainerConfig(total_steps=TRAIN_REPLAY["total"],
                               ckpt_dir=str(tmp / name),
                               ckpt_interval=TRAIN_REPLAY["interval"],
                               seed=0)
            tr = Trainer(model, optim.adamw(TRAIN_LR), data, tc,
                         failure_plan=plan, device="cuda")
            runs[name] = (tr, tr.run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (a, sa), (b, sb) = runs["straight"], runs["crashed"]
    equal = all(torch.equal(x, y) for x, y in zip(
        tree.leaves((sa.params, sa.opt_state)),
        tree.leaves((sb.params, sb.opt_state))))
    last = {h["step"]: h["loss"] for h in b.history}
    rec = dict(arch=cfg.name, steps=TRAIN_REPLAY["total"],
               restarts=b.restarts, bitwise=equal,
               losses_equal=all(last[h["step"]] == h["loss"]
                                for h in a.history),
               threefry_launches=threefry.LAUNCHES["threefry"])
    check_train_draws(torch, cfg, data, TRAIN_REPLAY["total"] - 1,
                      "train replay")
    print("[train] replay " + json.dumps(rec))
    check(b.restarts == 3 and int(sb.step) == TRAIN_REPLAY["total"],
          f"the crashed run: {rec}")
    check(equal and rec["losses_equal"],
          f"replay after crashes is not bitwise: {rec}")
    return rec


def train_exact(torch, np):
    """(e) Exact-mode training, TRAIN_PARITY_LAYERS layers at full width
    in f32: loss and every gradient through the cuda code route (the
    cim_mac kernel, launches counted) and through the plain torch route
    on the card, which must agree; then one make_train_step step with
    the 'auto' backend, which must resolve cuda and launch cim_mac once
    per matmul of the forward and of the remat re-forward."""
    import dataclasses
    from repro_torch import configs, optim, tree
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.data import DataConfig, lm_batch
    from repro_torch.kernels import backends
    from repro_torch.kernels import cim_mac as cm
    from repro_torch.models import registry
    from repro_torch.train import TrainState, make_train_step, value_and_grad
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              num_layers=TRAIN_PARITY_LAYERS,
                              dtype=torch.float32)
    model = registry.build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(3),
                        "cuda")
    rows, seq = TRAIN_PARITY_BATCH
    batch = lm_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                global_batch=rows, seed=3), 0,
                     device="cuda")
    got = {}
    for backend in ("cuda", "torch"):
        cim = CIMConfig(mode="exact", backend=backend).resolve("cuda")
        cm.reset_launches()
        torch.cuda.synchronize()
        t = time.monotonic()
        loss, grads = value_and_grad(model, params, batch, cim)
        grads = tree.leaves(grads)
        torch.cuda.synchronize()
        got[backend] = dict(loss=loss, grads=grads,
                            s=time.monotonic() - t,
                            launches=cm.LAUNCHES["cim_mac"],
                            routes=dict(cm.ROUTES))
    c, p = got["cuda"], got["torch"]
    per_forward = 7 * cfg.num_layers + 1
    remat = per_forward + 7 * cfg.num_layers
    check(c["launches"] == remat and c["routes"]["codes"] == remat
          and p["launches"] == 0,
          f"exact routes' launches: cuda {c['launches']} {c['routes']}, "
          f"torch {p['launches']} (want {remat} on codes)")
    gaps = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(c["grads"], p["grads"])]
    bitwise = bool(torch.equal(c["loss"], p["loss"])) and all(
        torch.equal(a, b) for a, b in zip(c["grads"], p["grads"]))
    zero = [float(g.abs().max()) == 0 for g in c["grads"]]
    del got, c, p
    opt = optim.adamw(TRAIN_LR)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device="cuda"))
    cm.reset_launches()
    fills = backends.CODE_WEIGHTS.fills
    state, m = make_train_step(model, opt, cim=CIMConfig(mode="exact"))(
        state, batch)
    m = {k: float(v) for k, v in m.items()}
    rec = dict(layers=cfg.num_layers, rows=rows, seq=seq, bitwise=bitwise,
               grad_max_rel_gap=max(gaps), zero_grad_leaves=sum(zero),
               step_launches=cm.LAUNCHES["cim_mac"],
               step_routes=dict(cm.ROUTES),
               step_code_fills=backends.CODE_WEIGHTS.fills - fills,
               step_metrics=m)
    print("[train] exact " + json.dumps(rec))
    check(max(gaps) <= 1e-6, f"exact mode, cuda vs torch route: {rec}")
    check(rec["step_launches"] == remat and np.isfinite(m["loss"])
          and np.isfinite(m["grad_norm"]), f"the exact train step: {rec}")
    return rec


def fam_draw(torch):
    """The VLM's patches of one step, FAM_DRAW bf16 words: the threefry
    kernel's bits against its plain version on the card (bitwise, timed,
    bound as the fidelity phase's draws), and the whole normal_bf16."""
    from repro_torch.core import prng
    from repro_torch.kernels import threefry
    k = prng.fold_in(prng.key(7), 0)
    n = math.prod(FAM_DRAW)
    blk = prng.flat_range(0, n)
    got = threefry.random_bits(k, blk, "cuda")
    check(torch.equal(got, prng.bits_torch(k, blk, "cuda")),
          f"threefry differs from its plain version on {n} words")
    del got
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    ms = time_ms(torch, lambda: threefry.random_bits(k, blk, "cuda"), 5,
                 flush)
    plain_ms = time_ms(torch, lambda: prng.bits_torch(k, blk, "cuda"), 3,
                       flush)
    normal_ms = time_ms(torch, lambda: prng.normal_bf16(k, FAM_DRAW,
                                                        "cuda"), 5, flush)
    rec = dict(threefry_record(ms, plain_ms, n), shape=list(FAM_DRAW),
               normal_bf16_ms=normal_ms,
               normal_bf16_bound_ms=max(
                   2 * n / HBM_BYTES_PER_S * 1e3,
                   threefry.OPS_PER_WORD * n / INT32_OPS_PER_S * 1e3))
    print("[train-families] draw " + json.dumps(rec))
    torch.cuda.empty_cache()
    return rec


def phase_train_families(torch, np, card, parity=True):
    """The training forward of the other four families (see the module
    docstring, phase 18).  Without ``parity`` the parity worker holds
    each cut to the CPU (attach_parity)."""
    fams = {}
    for arch in TRAIN_RUNS:
        if arch == TRAIN_ARCH:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        t = time.monotonic()
        rec = train_run(torch, np, arch, card)
        gc.collect()
        torch.cuda.empty_cache()
        rec["train_s"] = time.monotonic() - t
        if parity:
            rec["parity"] = train_parity(torch, np, arch)
        rec["wall_s"] = time.monotonic() - t
        print(f"[train-families] {arch}: {rec['train_s']:.1f} s trained, "
              f"{rec['wall_s']:.1f} s in all")
        fams[arch] = rec
    check(fams["llama-3.2-vision-90b"]["peak_bytes"] <= FAM_PEAK_LIMIT,
          "llama-3.2-vision-90b: peak past the limit at two groups")
    gc.collect()
    torch.cuda.empty_cache()
    draw = fam_draw(torch)
    return dict(families=fams, draw=draw,
                threefry_launches=sum(r["threefry_launches"]
                                      for r in fams.values()))


def run_summary(r, parity):
    """One training run's numbers of the last lines."""
    return {key: r[key] for key in (
        "card", "step_ms_median", "step_ms_min", "step_ms_max",
        "tokens_per_s", "mfu", "bound_ms", "peak_bytes", "device_idle_share",
        "threefry_launches_per_step")} | dict(
            first_loss=r["losses"][0], last_mean_loss=statistics.mean(
                r["losses"][-TRAIN_RUNS[r["arch"]]["fall"]:]),
            parity_loss_rel_err=parity["loss_rel_err"],
            parity_grad_norm_rel_err=parity["grad_norm_rel_err"],
            parity_moments_rel_err=parity["moments_rel_err"],
            parity_update_max_abs_err_over_lr=parity[
                "update_max_abs_err_over_lr"])


def train_families_summary(fam):
    """The families' numbers of the last lines."""
    return {arch: run_summary(r, r["parity"])
            for arch, r in fam["families"].items()}


def phase_train(torch, np, card, parity=True):
    """The training path (see the module docstring, phase 17).  Without
    ``parity`` the parity worker holds (c) (attach_parity)."""
    full = train_run(torch, np, TRAIN_ARCH, card)
    gc.collect()
    torch.cuda.empty_cache()
    launcher = train_launcher(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    parity = train_parity(torch, np, TRAIN_ARCH) if parity else None
    replay = train_replay(torch)
    exact = train_exact(torch, np)
    return dict(full=full, launcher=launcher, parity=parity, replay=replay,
                exact=exact,
                threefry_launches=full["threefry_launches"]
                + launcher["threefry_launches"]
                + replay["threefry_launches"],
                cim_mac_launches=exact["step_launches"])


def train_summary(train):
    """The training numbers of the last lines."""
    return run_summary(train["full"], train["parity"]) | dict(
        launcher_tokens_per_s=train["launcher"]["tokens_per_s"],
        launcher_checkpoint_bytes=train["launcher"]["checkpoint_bytes"],
        replay_bitwise=train["replay"]["bitwise"],
        exact_bitwise=train["exact"]["bitwise"])


def autotune_summary(tuned):
    """Per domain: the tuned and the rule's bucket run, side by side."""
    out = dict(tune_s=tuned["tune_s"],
               tracked_not_the_rule=tuned["tracked_not_the_rule"])
    for key, rec in tuned["runs"].items():
        if key.endswith("/tokens"):
            out[key] = rec["identical"]
        else:
            out[key] = {k: rec[k] for k in ("block_sources", "prefill_ms",
                                            "decode_step_ms", "tok_per_s")}
    return out


MESH_SHAPE = ((1, 1), ("data", "model"))
# train_optimizer's spec; the train phase's run cut to 4 of its 24 layers
# (the checkpoint written and read twice is 6.3 GB, not 19)
MESH_TRAIN = dict(optimizer="adamw", steps=3, layers=4)
MESH_SAVE_AT = 2                   # the meshed checkpoint, after step 2
MESH_TP_TOL = 1e-5       # (d): sharded vs whole kernel, of max|y| (f32)
# (f): the int8 and exact buckets, (batch, prompt tokens, new tokens)
MESH_DOMAIN_BUCKET = {"int8": (BATCH, PROMPT, 8), "exact": (BATCH, 32, 4)}
# (g): training on the mesh for every family, each at full width and cut
# depth, TRAIN_BATCH x TRAIN_SEQ tokens a step (exact mode: f32 at
# TRAIN_PARITY_BATCH), its optimizer at a constant lr (TRAIN_LR unless
# named): internlm2-1.8b with Adafactor, exact mode through cim_mac,
# mixtral-8x7b (3.16e9 params at 2 of 32 layers), and the recurrent and
# cross families below the train-families phase's depths (zamba2-7b one
# shared-block invocation and a tail, whisper 4 + 4, the VLM one group)
MESH_FAMILIES = (
    dict(tag="adafactor", arch=TRAIN_ARCH, layers=4, optimizer="adafactor",
         steps=3),
    dict(tag="exact", arch=TRAIN_ARCH, layers=2, optimizer="adamw",
         steps=2, exact=True),
    dict(tag="moe", arch="mixtral-8x7b", layers=2, optimizer="adafactor",
         steps=1),
    dict(tag="zamba2", arch="zamba2-7b", layers=ZAMBA_PARITY_LAYERS,
         optimizer="adafactor", steps=1, lr=3e-4),
    dict(tag="xlstm", arch="xlstm-125m", layers=4, optimizer="adamw",
         steps=1),
    dict(tag="whisper", arch="whisper-large-v3", layers=4,
         optimizer="adamw", steps=1),
    dict(tag="vlm", arch="llama-3.2-vision-90b", layers=5,
         optimizer="adafactor", steps=1))


def mesh_serve(torch, np, cfg, model, params, mesh, card):
    """(a) The bucket engine unmeshed and on the mesh, base3/float: one
    warm-up bucket each, then the counted bucket, then the engine's own
    prefill and decode steps timed outside it."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import greedy_sample
    cim = CIMConfig(mode="ternary", packing="base3")
    out = {}
    for tag, kw in (("unmeshed", {}),
                    ("meshed", dict(rules=shd.rules_for(cfg, "serve"),
                                    mesh=mesh))):
        def engine():
            return ServeEngine(model, params, capacity=CAPACITY,
                               max_batch=BATCH, cim=cim, device="cuda", **kw)
        rng = np.random.default_rng(7)
        eng = engine()
        for r in _requests(rng, cfg.vocab_size, BATCH):   # warm-up bucket
            r.max_new = 2
            eng.submit(r)
        eng.run()
        eng = engine()
        reqs = _requests(rng, cfg.vocab_size, BATCH)
        for r in reqs:
            eng.submit(r)
        tm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts, routes = dict(tm.LAUNCHES), dict(tm.ROUTES)
        check(counts["ternary_matmul"] > 0,
              f"mesh {tag}: ternary_matmul never launched")
        check(eng.host_transfers == 1,
              f"mesh {tag}: {eng.host_transfers} host transfers for one "
              f"bucket")
        prefill_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.monotonic()
            tok, state = eng._prefill(reqs)
            torch.cuda.synchronize()
            prefill_ms.append((time.monotonic() - t) * 1e3)
        steps = MAX_NEW - 2
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(steps):
            logits, state = eng._decode(tok, state)
            tok = greedy_sample(logits)
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t) * 1e3 / steps
        check(bool(torch.isfinite(logits).all()),
              f"mesh {tag}: non-finite logits")
        out[tag] = dict(tokens={r.uid: r.out_tokens for r in done},
                        launches=counts, routes=routes,
                        host_transfers=eng.host_transfers,
                        steps=eng.steps_run, wall_s=wall,
                        tok_per_s=eng.generated_tokens / wall,
                        prefill_ms=statistics.median(prefill_ms),
                        decode_step_ms=step_ms, card=card)
        print(f"[mesh] serve {tag} " + json.dumps(
            {k: v for k, v in out[tag].items() if k != "tokens"}))
        del eng, state, logits
    a, b = out["unmeshed"], out["meshed"]
    check(a["tokens"] == b["tokens"],
          "mesh: the meshed bucket's tokens differ from the unmeshed")
    check(a["launches"] == b["launches"] and a["routes"] == b["routes"],
          f"mesh: launches {b['launches']} / routes {b['routes']} on the "
          f"mesh, {a['launches']} / {a['routes']} unmeshed")
    check(a["steps"] == b["steps"], "mesh: steps_run differ")
    for r in out.values():
        del r["tokens"]
    return out


def _tree_bitwise(torch, a, b) -> list:
    """Paths of the leaves of ``a`` (DTensors gathered) that are not
    bitwise ``b``'s."""
    from repro_torch import tree
    from repro_torch.dist import runtime as rt
    return ["/".join(p) for (p, x), y in zip(tree.flatten_with_path(a),
                                             tree.leaves(b))
            if not torch.equal(rt.full(x), y)]


def mesh_train(torch, np, mesh_lib, mesh, card):
    """(b) and (c): 3 AdamW steps unmeshed and on the mesh, a checkpoint
    of the meshed state after step 2 restored unmeshed and onto a fresh
    mesh, each going on to step 3."""
    import tempfile
    from repro_torch import checkpoint as ckpt
    from repro_torch import tree
    from repro_torch.data import DataConfig, batch_for
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import threefry
    from repro_torch.models import registry
    from repro_torch.train import (TrainState, init_state,
                                   make_abstract_state, make_train_step,
                                   place_state)
    cfg = train_cfg(TRAIN_ARCH, MESH_TRAIN["layers"])
    model = registry.build(cfg)
    opt = train_optimizer(MESH_TRAIN)
    rules = shd.rules_for(cfg, "train")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    fresh = lambda: init_state(model, opt, torch.Generator(  # noqa: E731
        device="cuda").manual_seed(0), "cuda")

    def run(state, step_fn, start, stop):
        losses, ms = [], []
        for step in range(start, stop):
            torch.cuda.synchronize()
            t = time.monotonic()
            state, m = step_fn(state, batch_for(cfg, data, step,
                                                device="cuda"))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.monotonic() - t) * 1e3)
        return state, losses, ms

    stop = MESH_TRAIN["steps"]
    ref, ref_losses, ref_ms = run(fresh(), make_train_step(model, opt), 0,
                                  stop)
    state = place_state(fresh(), model, opt, rules, mesh)
    step_fn = make_train_step(model, opt, rules=rules, mesh=mesh)
    threefry.reset_launches()
    state, losses, ms = run(state, step_fn, 0, MESH_SAVE_AT)
    launches = threefry.LAUNCHES["threefry"]
    check(launches > 0, "mesh: threefry never launched in the meshed steps")
    out = dict(threefry_launches=launches, card=card)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.monotonic()
        ckpt.save(tmp, MESH_SAVE_AT, state)
        out["save_s"] = time.monotonic() - t
        state, more, ms2 = run(state, step_fn, MESH_SAVE_AT, stop)
        losses += more
        ms += ms2
        check(losses == ref_losses,
              f"mesh: meshed losses {losses} != unmeshed {ref_losses}")
        bad = (_tree_bitwise(torch, state.params, ref.params)
               + _tree_bitwise(torch, state.opt_state, ref.opt_state))
        check(not bad, f"mesh: {len(bad)} leaves differ from the unmeshed "
                       f"run after {stop} steps: {bad[:4]}")
        del state
        skeleton = lambda specs: tree.map_specs(lambda _: 0,  # noqa
                                                specs)
        target = TrainState(skeleton(model.param_specs),
                            skeleton(opt.state_defs(model.param_specs)), 0)
        for tag in ("unmeshed", "fresh mesh"):
            if tag == "unmeshed":
                placements, fn = None, make_train_step(model, opt)
            else:
                fresh_mesh = mesh_lib.make_mesh(
                    mesh_lib.MeshSpec(*MESH_SHAPE), "cuda")
                placements = make_abstract_state(model, opt, rules,
                                                 fresh_mesh)
                fn = make_train_step(model, opt, rules=rules,
                                     mesh=fresh_mesh)
            t = time.monotonic()
            got, _ = ckpt.restore(tmp, MESH_SAVE_AT, target=target,
                                  device="cuda", placements=placements)
            out[f"restore_s {tag}"] = time.monotonic() - t
            got, last, _ = run(TrainState(*got), fn, MESH_SAVE_AT, stop)
            check(last == ref_losses[MESH_SAVE_AT:],
                  f"mesh: restored {tag}: losses {last} != "
                  f"{ref_losses[MESH_SAVE_AT:]}")
            bad = (_tree_bitwise(torch, got.params, ref.params)
                   + _tree_bitwise(torch, got.opt_state, ref.opt_state))
            check(not bad, f"mesh: restored {tag}: {len(bad)} leaves "
                           f"differ at step {stop}: {bad[:4]}")
            del got
    out.update(losses=losses, ref_losses=ref_losses, step_ms=ms,
               ref_step_ms=ref_ms,
               step_ms_median=statistics.median(ms[1:]),
               ref_step_ms_median=statistics.median(ref_ms[1:]),
               bitwise=True)
    print("[mesh] train " + json.dumps(out))
    return out


def mesh_family_run(torch, mesh, spec, card):
    """One run of MESH_FAMILIES (see there): ``steps`` steps of the cut
    config unmeshed and then on the mesh, each from the same seeded
    init on the card and the same batches; the counts zeroed just
    before the meshed steps and read just after.  Losses and every
    param and optimizer-state leaf must be bitwise equal."""
    import dataclasses
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.data import DataConfig, batch_for
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import cim_mac as cm
    from repro_torch.kernels import threefry
    from repro_torch.models import registry
    from repro_torch.train import init_state, make_train_step, place_state
    cfg = train_cfg(spec["arch"], spec["layers"])
    cim = None
    rows, seq = TRAIN_BATCH, TRAIN_SEQ
    if spec.get("exact"):
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        cim = CIMConfig(mode="exact")
        rows, seq = TRAIN_PARITY_BATCH
    model = registry.build(cfg)
    opt = train_optimizer(spec, schedule=False)
    rules = shd.rules_for(cfg, "train")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=rows, seed=0)
    batches = [batch_for(cfg, data, i, device="cuda")
               for i in range(spec["steps"])]
    fresh = lambda: init_state(model, opt, torch.Generator(  # noqa: E731
        device="cuda").manual_seed(0), "cuda")

    def run(state, step_fn):
        losses, ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t = time.monotonic()
            state, m = step_fn(state, b)
            losses.append(float(m["loss"]))
            ms.append((time.monotonic() - t) * 1e3)
        return state, losses, ms

    ref, ref_losses, ref_ms = run(fresh(),
                                  make_train_step(model, opt, cim=cim))
    state = place_state(fresh(), model, opt, rules, mesh)
    step_fn = make_train_step(model, opt, cim=cim, rules=rules, mesh=mesh)
    cm.reset_launches()
    threefry.reset_launches()
    state, losses, ms = run(state, step_fn)
    torch.cuda.synchronize()
    rec = dict(arch=spec["arch"], layers=spec["layers"],
               optimizer=spec["optimizer"], steps=spec["steps"],
               rows=rows, seq=seq, params=cfg.param_count(),
               losses=losses, ref_losses=ref_losses, step_ms=ms,
               ref_step_ms=ref_ms,
               launches={"cim_mac": cm.LAUNCHES["cim_mac"],
                         "threefry": threefry.LAUNCHES["threefry"]},
               routes=dict(cm.ROUTES), card=card)
    bad = (_tree_bitwise(torch, state.params, ref.params)
           + _tree_bitwise(torch, state.opt_state, ref.opt_state))
    rec["bitwise"] = losses == ref_losses and not bad
    print(f"[mesh] train-families {spec['tag']} " + json.dumps(rec))
    check(all(map(math.isfinite, losses)),
          f"mesh (g) {spec['tag']}: non-finite loss {losses}")
    check(losses == ref_losses,
          f"mesh (g) {spec['tag']}: meshed losses {losses} != unmeshed "
          f"{ref_losses}")
    check(not bad, f"mesh (g) {spec['tag']}: {len(bad)} leaves differ "
                   f"from the unmeshed run: {bad[:4]}")
    if spec.get("exact"):
        check(rec["launches"]["cim_mac"] > 0
              and rec["routes"].get("codes") == rec["launches"]["cim_mac"],
              f"mesh (g) exact: cim_mac launches {rec['launches']} routes "
              f"{rec['routes']} (want every call on codes)")
    return rec


def mesh_train_families(torch, mesh, card):
    """(g) Every family's training on the mesh, one MESH_FAMILIES run at
    a time (the card's memory freed between them)."""
    out = {}
    for spec in MESH_FAMILIES:
        out[spec["tag"]] = mesh_family_run(torch, mesh, spec, card)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_sched(torch, np, cfg, model, params, mesh, card):
    """(e) The dense Scheduler and the PagedScheduler's gather read on the
    first SCHED_CUT requests of the bursty trace, unmeshed and with
    ``rules=, mesh=`` (phase 5's runs and checks each, counts zeroed just
    before and read just after every run): tokens, launches and routes
    equal, one transfer per chunk, ms a decode step of both; then both
    meshed schedulers under ``analysis.sanitize``."""
    from repro_torch.dist import sharding as shd
    specs = sched_requests(np, cfg, seed=21)[:SCHED_CUT]
    kw = dict(rules=shd.rules_for(cfg, "serve"), mesh=mesh)
    runs = {}
    for tag, mesh_kw in (("unmeshed", None), ("meshed", kw)):
        recs, tokens = phase_sched(torch, np, cfg, model, params, specs=specs,
                                   kinds=("dense", "gather"),
                                   tag=f"mesh sched {tag}", mesh_kw=mesh_kw)
        runs[tag] = dict(records=recs, tokens=tokens)
    out = {}
    for kind in ("dense", "gather"):
        a, b = (runs[t]["records"][kind] for t in ("unmeshed", "meshed"))
        check(runs["unmeshed"]["tokens"][kind]
              == runs["meshed"]["tokens"][kind],
              f"mesh sched {kind}: meshed tokens differ from unmeshed")
        check(a["launches"] == b["launches"] and a["routes"] == b["routes"],
              f"mesh sched {kind}: launches {b['launches']} / routes "
              f"{b['routes']} meshed, {a['launches']} / {a['routes']} "
              f"unmeshed")
        check(b["attn_backend"] is None,
              f"mesh sched {kind}: the meshed read took "
              f"{b['attn_backend']}, not the gather path")
        out[kind] = {t: {k: runs[t]["records"][kind][k] for k in (
            "decode_ms_per_step", "wall_s", "chunks", "host_transfers",
            "decode_steps", "launches", "routes", "pages_in_use_peak",
            "prefix_hit_rate")} for t in runs}
        out[kind]["card"] = card
    out["sanitize"] = phase_sanitize(torch, np, cfg, model, params,
                                     kinds=("dense", "gather"), mesh_kw=kw,
                                     tag="mesh sanitize")
    print("[mesh] sched " + json.dumps(
        {k: v for k, v in out.items() if k != "sanitize"}))
    return out


def mesh_domains(torch, np, cfg, model, params, mesh, card):
    """(f) The int8 domain on the packed weights and exact mode on float
    weights of the same seeded init, each a bucket engine unmeshed and on
    the mesh: a warm-up bucket, then the counted bucket (counts zeroed
    just before, read just after), then the engine's own prefill and one
    decode step: tokens, launches and routes equal, logits bitwise, no
    code-weight fill after the warm-up."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import backends
    from repro_torch.kernels import cim_mac as cm
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serve import Request, ServeEngine
    floats = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    out = {}
    for domain, (batch, prompt, new) in MESH_DOMAIN_BUCKET.items():
        if domain == "int8":
            cim, weights = CIMConfig(mode="ternary", packing="base3",
                                     domain="int8"), params
        else:
            cim, weights = CIMConfig(mode="exact"), floats
        rng = np.random.default_rng(31)
        prompts = rng.integers(0, cfg.vocab_size, (batch, prompt))
        got = {}
        for tag, kw in (("unmeshed", {}),
                        ("meshed", dict(rules=shd.rules_for(cfg, "serve"),
                                        mesh=mesh))):
            eng = ServeEngine(model, weights, capacity=CAPACITY,
                              max_batch=batch, cim=cim, device="cuda", **kw)
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new=2))
            eng.run()
            fills = backends.CODE_WEIGHTS.fills
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=100 + i, prompt=p, max_new=new))
            tm.reset_launches()
            cm.reset_launches()
            torch.cuda.synchronize()
            t = time.monotonic()
            done = [r for r in eng.run() if r.uid >= 100]
            torch.cuda.synchronize()
            wall = time.monotonic() - t
            launches = {k: v for k, v in {**tm.LAUNCHES, **cm.LAUNCHES}
                        .items() if v}
            routes = {k: v for k, v in {**tm.ROUTES, **cm.ROUTES}.items()
                      if v}
            tok, state = eng._prefill([Request(uid=i, prompt=p)
                                       for i, p in enumerate(prompts)])
            logits, _ = eng._decode(tok, state)
            got[tag] = dict(tokens={r.uid: r.out_tokens for r in done},
                            launches=launches, routes=routes,
                            host_transfers=eng.host_transfers,
                            fills=backends.CODE_WEIGHTS.fills - fills,
                            backend=eng.cim.backend, wall_s=wall,
                            tok=tok, logits=logits)
            del eng, state
        a, b = got["unmeshed"], got["meshed"]
        check(a["tokens"] == b["tokens"],
              f"mesh {domain}: meshed tokens differ from unmeshed")
        check(a["launches"] == b["launches"] and a["routes"] == b["routes"]
              and b["launches"], f"mesh {domain}: launches {b['launches']} "
              f"/ routes {b['routes']} meshed, {a['launches']} / "
              f"{a['routes']} unmeshed")
        bitwise = (torch.equal(a["tok"], b["tok"])
                   and torch.equal(a["logits"], b["logits"]))
        check(bitwise, f"mesh {domain}: meshed logits not bitwise")
        check(b["fills"] == 0 and a["fills"] == 0,
              f"mesh {domain}: {b['fills']} code-weight fills after the "
              f"warm-up")
        out[domain] = {t: {k: v for k, v in got[t].items()
                           if k not in ("tok", "logits", "tokens")}
                       for t in got}
        out[domain].update(bitwise=bitwise, card=card)
        print(f"[mesh] {domain} " + json.dumps(out[domain]))
    del floats
    return out


def mesh_int8_rows(torch, cfg):
    """(d, int8) The int8 domain's row split: w2's (8192, 2048) and a
    (2046, 2048) weight cut in two along K, each shard's int32 sums
    through the kernel's int32 epilogue (``ShardedPacked.partial_int32``
    on x quantized over its whole row), added in int32, then the
    epilogue once: bitwise the unsplit ``ternary_matmul_int8``, at M = 8
    and 1024.  Comparison launches: counted by no main-path read."""
    from repro_torch.core.cim_linear import CIMConfig, linear
    from repro_torch.dist.runtime import ShardedPacked
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_matmul as tm
    d, f = cfg.d_model, cfg.d_ff
    cases = []
    for packing in ("base3", "trit2"):
        cim = CIMConfig(mode="ternary", packing=packing, domain="int8")
        for k, n in ((f, d), (d - 2, d)):
            g = torch.Generator("cuda").manual_seed(k + n + 1)
            w = ops.pack_weights(torch.randn(k, n, generator=g,
                                             device="cuda"), packing)
            shards = [ShardedPacked(part.contiguous(), w.scale, packing,
                                    None, "row")
                      for part in w.data.chunk(2, dim=-2)]
            for m in (BATCH, 1024):
                x = torch.randn(m, k, generator=g, device="cuda").to(
                    torch.bfloat16)
                want = linear(x, w, cim)
                tm.reset_launches()
                parts = [sh.partial_int32(x, i) for i, sh in
                         enumerate(shards)]
                got = shards[0].epilogue(parts[0][0] + parts[1][0],
                                         parts[0][1], (m,))
                routes = {r: c for r, c in tm.ROUTES.items() if c}
                rec = dict(packing=packing, k=k, n=n, m=m, routes=routes,
                           bitwise=bool(torch.equal(got, want)))
                print("[mesh] int8 rows " + json.dumps(rec))
                check(tm.LAUNCHES["ternary_matmul_int8"] == 2,
                      f"mesh int8 rows {packing} {k}x{n} M={m}: "
                      f"{tm.LAUNCHES} for 2 shards")
                check(rec["bitwise"], f"mesh int8 rows {packing} {k}x{n} "
                                      f"M={m}: not bitwise the unsplit "
                                      f"kernel")
                cases.append(rec)
    return cases


def mesh_tensor_parallel(torch, cfg):
    """(d) Two model-axis shards of a packed weight, each through
    ``linear``'s planned kernel on its local shape, joined as the mesh's
    collective joins them (columns concatenated, partial products
    summed), against the unsharded kernel.  Comparison launches: counted
    by no main-path read."""
    from repro_torch.core.cim_linear import CIMConfig, linear
    from repro_torch.dist.runtime import ShardedPacked
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_matmul as tm
    d, f = cfg.d_model, cfg.d_ff
    cases = []
    for packing in ("base3", "trit2"):
        cim = CIMConfig(mode="ternary", packing=packing)
        for k, n, split in ((d, f, "col"), (f, d, "row"),
                            (d - 2, d, "row")):
            g = torch.Generator("cuda").manual_seed(k + n)
            w = ops.pack_weights(torch.randn(k, n, generator=g,
                                             device="cuda"), packing)
            dim = -1 if split == "col" else -2
            scales = (w.scale.chunk(2, dim=-1) if split == "col"
                      else [w.scale] * 2)
            shards = [ShardedPacked(a.contiguous(), b.contiguous(), packing,
                                    None, split)
                      for a, b in zip(w.data.chunk(2, dim=dim), scales)]
            for m in (BATCH, 1024):
                x = torch.randn(m, k, generator=g, device="cuda").to(
                    torch.bfloat16)
                want = linear(x, w, cim)
                tm.reset_launches()
                parts = []
                for i, shard in enumerate(shards):
                    shard.apply = (lambda xi, run, s=shard, i=i:
                                   s.partial(xi, run, i))
                    parts.append(linear(x, shard, cim))
                got = (torch.cat(parts, dim=-1) if split == "col"
                       else parts[0] + parts[1])
                routes = {r: c for r, c in tm.ROUTES.items() if c}
                check(tm.LAUNCHES["ternary_matmul"] == 2,
                      f"mesh tp {packing} {k}x{n} {split} M={m}: "
                      f"{tm.LAUNCHES['ternary_matmul']} launches for 2 "
                      f"shards")
                check(got.shape == want.shape,
                      f"mesh tp: shape {tuple(got.shape)} != "
                      f"{tuple(want.shape)}")
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                rec = dict(packing=packing, k=k, n=n, split=split, m=m,
                           routes=routes, max_abs_err=err, max_abs_y=scale)
                print("[mesh] tp " + json.dumps(rec))
                check(err <= MESH_TP_TOL * scale,
                      f"mesh tp {packing} {k}x{n} {split} M={m}: error "
                      f"{err} > {MESH_TP_TOL} x {scale}")
                cases.append(rec)
    return cases


def phase_mesh(torch, np, cfg, model, params, card):
    """19. The sharding layer on a one-card mesh (see the docstring):
    the process group is started here and destroyed before returning;
    nothing is caught."""
    from repro_torch.dist import mesh as mesh_lib
    mesh_lib.init_process_group("cuda")
    try:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(*MESH_SHAPE), "cuda")
        serve = mesh_serve(torch, np, cfg, model, params, mesh, card)
        sched = mesh_sched(torch, np, cfg, model, params, mesh, card)
        domains = mesh_domains(torch, np, cfg, model, params, mesh, card)
        train = mesh_train(torch, np, mesh_lib, mesh, card)
        families = mesh_train_families(torch, mesh, card)
    finally:
        mesh_lib.destroy_process_group()
    tp = mesh_tensor_parallel(torch, cfg)
    rows = mesh_int8_rows(torch, cfg)
    return dict(mesh=list(MESH_SHAPE), backend="nccl", serve=serve,
                sched=sched, domains=domains, train=train,
                train_families=families, tensor_parallel=tp,
                int8_rows=rows)


def mesh_summary(mesh):
    s, t = mesh["serve"], mesh["train"]
    return dict(
        prefill_ms={k: s[k]["prefill_ms"] for k in s},
        decode_step_ms={k: s[k]["decode_step_ms"] for k in s},
        sched_ms_per_step={
            kind: {t: mesh["sched"][kind][t]["decode_ms_per_step"]
                   for t in ("unmeshed", "meshed")}
            for kind in ("dense", "gather")},
        domains_bitwise={d: mesh["domains"][d]["bitwise"]
                         for d in mesh["domains"]},
        int8_rows_bitwise=all(c["bitwise"] for c in mesh["int8_rows"]),
        train_step_ms={"unmeshed": t["ref_step_ms_median"],
                       "meshed": t["step_ms_median"]},
        save_s=t["save_s"], bitwise=t["bitwise"],
        train_families={k: dict(bitwise=r["bitwise"],
                                step_ms=r["step_ms"],
                                ref_step_ms=r["ref_step_ms"])
                        for k, r in mesh["train_families"].items()},
        tp_worst=max(c["max_abs_err"] / c["max_abs_y"]
                     for c in mesh["tensor_parallel"]))


DRYRUN_PEAK_TOL = 0.10        # predicted live-bytes peak vs the card's
DRYRUN_CLI_TIMEOUT = 900      # seconds for the CLI's production cell
DRYRUN_REPORT_KEYS = (        # the reference's report keys
    "arch", "shape", "mesh", "packed", "lower_s", "compile_s", "chips",
    "flops_per_device", "bytes_per_device", "wire_bytes_per_device",
    "t_compute", "t_memory", "t_collective", "bottleneck",
    "model_flops_total", "useful_ratio", "peak_fraction", "collectives",
    "memory_stats")


def dryrun_cell(torch, tm, name, fn, inputs, cell, **kwargs):
    """One calibration cell: the dry run's prediction on a fake (1, 1)
    mesh, then ``fn`` on the card (warmed up before): its launches and
    routes, its peak counted from its inputs, its profiled busy time;
    the checks of phase 20 (a)."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline.op_cost import storage_bytes
    pred = dryrun.run_cell(ARCH, cell, mesh_shape=(1, 1), **kwargs)
    c = pred["collectives"]
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tm.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before
            + storage_bytes(inputs))
    launches = {k: v for k, v in tm.LAUNCHES.items() if v}
    routes = {k: v for k, v in tm.ROUTES.items() if v}
    del out
    busy, kernels, _ = device_busy(torch, fn)
    terms = {"compute": pred["t_compute"], "memory": pred["t_memory"],
             "collective": pred["t_collective"]}
    bound_ms = max(terms.values()) * 1e3
    pred_peak = pred["memory_stats"]["peak_bytes"]
    rec = dict(cell=name, predicted_calls=c["kernels"],
               launches=launches, predicted_routes=c["routes"],
               routes=routes, predicted_peak=pred_peak, peak=peak,
               peak_ratio=pred_peak / peak,
               peak_by_category=pred["memory_stats"]["peak_by_category"],
               busy_ms=busy, kernels=kernels, bound_ms=bound_ms,
               bound_by=pred["bottleneck"],
               terms_ms={k: v * 1e3 for k, v in terms.items()},
               busy_over_bound=busy / bound_ms,
               products=c["products"],
               packed_weight_bytes=c["packed_weight_bytes"],
               bytes_per_device=pred["bytes_per_device"],
               trace_s=pred["lower_s"])
    print("[dryrun] " + json.dumps(rec))
    check(c["kernels"] == launches and c["routes"] == routes,
          f"dryrun {name}: predicted calls {c['kernels']} on "
          f"{c['routes']}, the card launched {launches} on {routes}")
    check(abs(pred_peak - peak) <= DRYRUN_PEAK_TOL * peak,
          f"dryrun {name}: predicted peak {pred_peak} B, the card's "
          f"{peak} B")
    check(bound_ms <= busy, f"dryrun {name}: roofline {bound_ms:.3f} ms "
                            f"above the device busy {busy:.3f} ms")
    return rec


def dryrun_chunk(torch, np, tm, cfg, model, params, cim):
    """20 (a) one chunk of the Scheduler: SLOTS slots at capacity
    SCHED_CAPACITY, CHUNK decode steps, predicted (``--continuous``) on a
    fake (1, 1) mesh, then run on the card after a warm-up chunk (the
    counts zeroed just before and read just after): the predicted
    ternary-matmul calls and routes are the card's."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.serve import Request, Scheduler
    pred = dryrun.run_cell(
        ARCH, ShapeCell("sched_chunk", SCHED_CAPACITY, SLOTS, "decode"),
        mesh_shape=(1, 1), packed="base3", continuous=SLOTS,
        decode_loop=CHUNK, capacity=SCHED_CAPACITY)
    c = pred["collectives"]
    eng = Scheduler(model, params, capacity=SCHED_CAPACITY, slots=SLOTS,
                    chunk=CHUNK, cim=cim, device="cuda")
    rng = np.random.default_rng(30)
    for i in range(SLOTS):
        eng.try_admit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, PROMPT).astype(np.int32),
            max_new=2 * CHUNK + 1))
    eng._run_chunk()
    tm.reset_launches()
    torch.cuda.synchronize()
    t = time.monotonic()
    eng._run_chunk()
    torch.cuda.synchronize()
    ms = (time.monotonic() - t) * 1e3
    launches = {k: v for k, v in tm.LAUNCHES.items() if v}
    routes = {k: v for k, v in tm.ROUTES.items() if v}
    rec = dict(cell="chunk", slots=SLOTS, chunk=CHUNK,
               predicted_calls=c["kernels"], launches=launches,
               predicted_routes=c["routes"], routes=routes, chunk_ms=ms,
               bound_ms=max(pred["t_compute"], pred["t_memory"],
                            pred["t_collective"]) * 1e3,
               bound_by=pred["bottleneck"], trace_s=pred["lower_s"])
    print("[dryrun] " + json.dumps(rec))
    check(c["kernels"] == launches and c["routes"] == routes,
          f"dryrun chunk: predicted calls {c['kernels']} on {c['routes']}, "
          f"the card launched {launches} on {routes}")
    del eng
    return rec


def dryrun_cli(src):
    """The CLI's production cell, started in the background: it traces
    on fake tensors and needs no card."""
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", "train_4k", "--out-dir",
         str(ROOT / "chiprun_out" / "dryrun_torch")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, preexec_fn=lambda: os.nice(10))


def stop(proc):
    """End a background process that is still running."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def phase_dryrun(torch, np, cfg, model):
    """20 (a). The dry run's roofline against the card (see the
    docstring); the CLI's cell (b) runs beside it."""
    from repro_torch import optim
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.core.cim_linear import CIMConfig, ternarize_params
    from repro_torch.data import DataConfig, batch_for
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.kernels.ops import PackedTernary
    from repro_torch.roofline.op_cost import storage_bytes
    from repro_torch.train import init_state, make_train_step
    from repro_torch import tree
    cells = {}
    params = ternarize_params(
        model.init(torch.Generator(device="cuda").manual_seed(0),
                   device="cuda"), CIMConfig(mode="ternary",
                                             packing="base3"))
    cim = CIMConfig(mode="ternary", packing="base3").resolve("cuda")
    rng = np.random.default_rng(29)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (BATCH, PROMPT)), dtype=torch.int32,
        device="cuda")

    def prefill():
        return model.prefill(params, tokens, CAPACITY, cim=cim)
    prefill()
    cells["prefill"] = dryrun_cell(
        torch, tm, "prefill", prefill, {"p": params, "t": tokens},
        ShapeCell("bucket_prefill", PROMPT, BATCH, "prefill"),
        packed="base3", capacity=CAPACITY)
    logits, state = prefill()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    del logits

    def decode():
        return model.decode(params, tok, state, cim=cim)
    decode()
    cells["decode"] = dryrun_cell(
        torch, tm, "decode", decode,
        {"p": params, "t": tok,
         "s": {k: v for k, v in state.items() if k != "pos"}},
        ShapeCell("bucket_decode", CAPACITY, BATCH, "decode"),
        packed="base3")
    packed = sum(x.data.numel() + 4 * x.scale.numel()
                 for x in tree.leaves(params)
                 if isinstance(x, PackedTernary))
    floor = storage_bytes({k: v for k, v in params.items()
                           if k != "embed"})
    check(cells["decode"]["packed_weight_bytes"] == packed,
          f"dryrun decode: the roofline's packed-matmul bytes "
          f"{cells['decode']['packed_weight_bytes']} are not the "
          f"floor's packed weights {packed}")
    cells["decode"]["floor_ms"] = floor / HBM_BYTES_PER_S * 1e3
    del state, tok, tokens
    cells["chunk"] = dryrun_chunk(torch, np, tm, cfg, model, params, cim)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    opt = optim.adamw(optim.warmup_cosine(3e-4, 1000, 100_000))
    tstate = init_state(model, opt, torch.Generator(
        device="cuda").manual_seed(0), "cuda")
    batch = batch_for(cfg, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0), 0, device="cuda")
    step_fn = make_train_step(model, opt)

    def train():
        return step_fn(tstate, batch)
    train()
    distinct = int(torch.unique(batch["tokens"]).numel())
    ops = step_ops(torch, train)
    cells["train"] = dryrun_cell(
        torch, tm, "train", train,
        {"p": tstate.params, "o": tstate.opt_state, "s": tstate.step,
         "b": batch},
        ShapeCell("train_step", TRAIN_SEQ, TRAIN_BATCH, "train"),
        opt_name="adamw", unique_count=lambda n: distinct)
    got = cells["train"]["products"]
    check(got["bf16"] == ops["bf16"] and got["f32"] == ops["f32"],
          f"dryrun train: predicted products {got}, step_ops {ops}")
    cells["train"]["step_ops"] = ops
    cells["train"]["train_bound_ms"] = train_bound(
        torch, model, ops, "adamw")[0]
    return cells


def dryrun_cli_report(cli):
    """20 (b). The CLI's production cell, started with phase 20 (a):
    its exit code and its report's keys."""
    out_dir = ROOT / "chiprun_out" / "dryrun_torch"
    stdout, stderr = cli.communicate(timeout=DRYRUN_CLI_TIMEOUT)
    print(stdout.strip())
    check(cli.returncode == 0, f"dryrun CLI exit {cli.returncode}: "
                               f"{stderr[-2000:]}")
    with open(out_dir / f"{ARCH}__train_4k__16x16.json") as f:
        report = json.load(f)
    missing = [k for k in DRYRUN_REPORT_KEYS if k not in report]
    check(not missing, f"dryrun CLI report lacks {missing}")
    cli_rec = {k: report[k] for k in (
        "mesh", "chips", "flops_per_device", "bytes_per_device",
        "wire_bytes_per_device", "t_compute", "t_memory", "t_collective",
        "bottleneck", "useful_ratio", "fits", "lower_s")}
    cli_rec["peak_bytes"] = report["memory_stats"]["peak_bytes"]
    print("[dryrun cli] " + json.dumps(cli_rec))
    return cli_rec


def dryrun_summary(dr):
    c = {k: v for k, v in dr["cells"].items() if k != "chunk"}
    return dict(
        busy_over_bound={k: c[k]["busy_over_bound"] for k in c},
        bound_by={k: c[k]["bound_by"] for k in c},
        peak_ratio={k: c[k]["peak_ratio"] for k in c},
        calls={k: v["launches"] for k, v in dr["cells"].items()},
        chunk_ms=dr["cells"]["chunk"]["chunk_ms"],
        train_bound_ms=c["train"]["train_bound_ms"],
        decode_floor_ms=c["decode"]["floor_ms"],
        cli_s=dr["cli"]["lower_s"], cli_fits=dr["cli"]["fits"])


# the parity worker: the card-vs-CPU checks of phases 8 and 17-18 in a
# process of its own (``--parity-worker``), started after the build; it
# does every card part first (the VLM's, the largest, first), keeping
# what they leave on the card, writes PARITY_READY, moves it all to the
# host, then does the CPU parts on PARITY_THREADS of the host's cores
# (in TRAIN_RUNS's order, the VLM's last) while the main process goes
# on with the card, and writes PARITY_OUT
PARITY_DIR = ROOT / "chiprun_out" / "parity_worker"
PARITY_READY = PARITY_DIR / "ready"
PARITY_OUT = PARITY_DIR / "result.json"
PARITY_LOG = PARITY_DIR / "log.txt"
PARITY_THREADS = 5
PARITY_READY_TIMEOUT = 300     # seconds for the card parts
PARITY_TIMEOUT = 900           # seconds for the whole worker


def parity_worker(torch, np, cfg, card):
    """The worker's body (see PARITY_DIR): phase 8's device-MAC layer
    (fid_layer_card, fid_layer_cpu) and train_parity of every row of
    TRAIN_RUNS.  Raises as the phases would."""
    jobs = {arch: parity_card(torch, np, arch)
            for arch in sorted(TRAIN_RUNS, key=lambda a: a != VLM_ARCH)}
    layer = fid_layer_card(torch, np, cfg, card)
    torch.cuda.synchronize()
    PARITY_READY.write_text(json.dumps(dict(
        seconds=time.monotonic() - T_IMPORT,
        max_memory_allocated=torch.cuda.max_memory_allocated())))
    os.nice(10)             # the main process's host thread comes first
    for job in jobs.values():
        parity_offload(torch, job)
    torch.set_num_threads(PARITY_THREADS)
    out = dict(layer=fid_layer_cpu(torch, layer), train={})
    del layer
    for arch in TRAIN_RUNS:
        out["train"][arch] = parity_cpu(torch, np, jobs.pop(arch))
        gc.collect()
    out["seconds"] = time.monotonic() - T_IMPORT
    PARITY_OUT.write_text(json.dumps(out))


def parity_start(src):
    """Start the parity worker on ``src``; its output goes to
    PARITY_LOG."""
    PARITY_DIR.mkdir(parents=True, exist_ok=True)
    for path in (PARITY_READY, PARITY_OUT):
        path.unlink(missing_ok=True)
    with open(PARITY_LOG, "w") as log:
        return subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--parity-worker",
             "--src", str(src)], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT)


def parity_wait(proc, path, timeout):
    """Wait for the worker to write ``path``; fail with its log's end if
    it exits without or takes past ``timeout`` seconds."""
    t = time.monotonic()
    while not path.exists():
        done = proc.poll() is not None
        if done and not path.exists():
            check(False, f"parity worker exited {proc.returncode} "
                         f"without {path.name}: "
                         f"{PARITY_LOG.read_text()[-3000:]}")
        check(time.monotonic() - t < timeout,
              f"parity worker: no {path.name} after {timeout} s")
        time.sleep(0.2)
    return time.monotonic() - t


def parity_ready(proc):
    """The worker's card parts are done: the card is the main process's
    again.  Returns the seconds waited and the worker's own report."""
    waited = parity_wait(proc, PARITY_READY, PARITY_READY_TIMEOUT)
    return dict(waited_s=waited, **json.loads(PARITY_READY.read_text()))


def parity_result(proc):
    """The worker's records, once it has exited 0."""
    waited = parity_wait(proc, PARITY_OUT, PARITY_TIMEOUT)
    proc.wait(timeout=60)
    for line in PARITY_LOG.read_text().splitlines():
        if line.startswith("["):
            print(line)
    check(proc.returncode == 0, f"parity worker exited {proc.returncode}: "
                                f"{PARITY_LOG.read_text()[-3000:]}")
    out = json.loads(PARITY_OUT.read_text())
    out["waited_s"] = waited
    return out


def attach_parity(par, fid, train, families):
    """Put the worker's records where the in-process phases put them."""
    fid["layer"] = par["layer"]
    train["parity"] = par["train"][TRAIN_ARCH]
    for arch, rec in families["families"].items():
        rec["parity"] = par["train"][arch]


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paged-only", action="store_true",
                    help="build, then run only the paged-kernel phase")
    ap.add_argument("--moe-only", action="store_true",
                    help="build, then run only the moe phase")
    ap.add_argument("--int8-kv-only", action="store_true",
                    help="build, then run only the int8-kv phase (on its "
                         "own draw of internlm2-1.8b's weights)")
    ap.add_argument("--recurrent-only", action="store_true",
                    help="build, then run only the recurrent phases")
    ap.add_argument("--cross-only", action="store_true",
                    help="build, then run only the cross phases")
    ap.add_argument("--train-only", action="store_true",
                    help="build, then run only the train phase")
    ap.add_argument("--train-families-only", action="store_true",
                    help="build, then run only the train-families phase")
    ap.add_argument("--autotune-only", action="store_true",
                    help="build, then run only the autotune phase")
    ap.add_argument("--sanitize-only", action="store_true",
                    help="build, then run only the sanitize and analysis "
                         "phases")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build, then run only the mesh phase (on its own "
                         "draw of internlm2-1.8b's base3 weights)")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="build, then run only the dryrun phase")
    ap.add_argument("--parity-worker", action="store_true",
                    help="the whole run's parity worker (see PARITY_DIR): "
                         "started by the whole run itself")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the tree holding the repro_torch package to run "
                         "(with --paged-only: another checkout's, to time "
                         "its kernel on the same cases)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.cim_linear import CIMConfig, ternarize_params
    from repro_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    phases = []

    def run(name, fn, *args, **kwargs):
        """One phase, with its seconds and its device-memory peak.  What
        earlier phases left behind in reference cycles is collected
        first (the frontend phase's server and its hooked submit form
        one, holding two models' weights)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t = time.monotonic()
        result = fn(*args, **kwargs)
        torch.cuda.synchronize()
        rec = dict(phase=name, seconds=time.monotonic() - t,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   resident_before=resident)
        print("[phase] " + json.dumps(rec))
        phases.append(rec)
        return result

    if args.parity_worker:
        parity_worker(torch, np, configs.get(ARCH), card_line())
        return 0
    run("build", phase_build)
    card = card_line()
    print(f"[card] {card}")

    cfg = configs.get(ARCH)
    if args.paged_only:
        paged = phase_paged_kernel(torch, np, cfg,
                                   other=src != (ROOT / "src").resolve())
        print(f"[done] {time.monotonic() - t_start:.1f} s, {src}")
        print(card)
        print(json.dumps({"paged_kernel": paged}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.train_families_only:
        fam = run("train-families", phase_train_families, torch, np, card)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_train_families.json").write_text(
            json.dumps(dict(card=card, train_families=fam, phases=phases),
                       indent=1))
        print(f"[done] {time.monotonic() - t_start:.1f} s")
        print("[train-families] summary " + json.dumps(
            train_families_summary(fam)))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.train_only:
        train = run("train", phase_train, torch, np, card)
        print(f"[done] {time.monotonic() - t_start:.1f} s")
        print("[train] summary " + json.dumps(train_summary(train)))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.autotune_only or args.sanitize_only:
        model = registry.build(cfg)
        params = ternarize_params(
            model.init(torch.Generator(device="cuda").manual_seed(0),
                       device="cuda"),
            CIMConfig(mode="ternary", packing="base3"))
        if args.autotune_only:
            tuned = run("autotune", phase_autotune, torch, np, cfg, model,
                        params, card)
            print("[autotune] summary " + json.dumps(autotune_summary(tuned)))
        if args.sanitize_only:
            run("sanitize", phase_sanitize, torch, np, cfg, model, params)
            del params
            run("analysis", phase_analysis, torch)
        print(f"[done] {time.monotonic() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.dryrun_only:
        cli = dryrun_cli(src)
        try:
            cells = run("dryrun", phase_dryrun, torch, np, cfg,
                        registry.build(cfg))
            dr = dict(cells=cells, cli=run("dryrun-cli", dryrun_cli_report,
                                           cli))
        finally:
            stop(cli)
        print(f"[done] {time.monotonic() - t_start:.1f} s")
        print("[dryrun] summary " + json.dumps(dryrun_summary(dr)))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.mesh_only:
        model = registry.build(cfg)
        params = ternarize_params(
            model.init(torch.Generator(device="cuda").manual_seed(0),
                       device="cuda"),
            CIMConfig(mode="ternary", packing="base3"))
        mesh = run("mesh", phase_mesh, torch, np, cfg, model, params, card)
        print(f"[done] {time.monotonic() - t_start:.1f} s")
        print("[mesh] summary " + json.dumps(mesh_summary(mesh)))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if (args.moe_only or args.int8_kv_only or args.recurrent_only
            or args.cross_only):
        if args.moe_only:
            run("moe", phase_moe, torch, np)
        if args.int8_kv_only:
            model = registry.build(cfg)
            params = ternarize_params(
                model.init(torch.Generator(device="cuda").manual_seed(0),
                           device="cuda"),
                CIMConfig(mode="ternary", packing="base3"))
            run("int8-kv", phase_int8_kv, torch, np, cfg, model, params)
            del params
        if args.recurrent_only:
            for arch in REC_ARCHS:
                run(f"recurrent {arch}", phase_recurrent, torch, np, arch)
        if args.cross_only:
            for arch in CROSS_ARCHS:
                run(f"cross {arch}", phase_cross, torch, np, arch)
        print(f"[done] {time.monotonic() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    # beside the card's phases: the CLI's cell traces on the host, and the
    # parity worker does its card parts (the analysis CLI beside them),
    # then its CPU parts
    cli = dryrun_cli(src)
    worker = parity_start(src)
    try:
        analysis = run("analysis", phase_analysis, torch)
        parity_card_s = run("parity-card", parity_ready, worker)
        cases, floor_ms = run("kernels", phase_kernels, torch, cfg)
        print_matmul_sums(cases, floor_ms)
        paged = run("paged-kernel", phase_paged_kernel, torch, np, cfg)

        model = registry.build(cfg)

        def init_packed():
            params = model.init(torch.Generator(
                device="cuda").manual_seed(0), device="cuda")
            return {p: ternarize_params(params, CIMConfig(
                mode="ternary", packing=p)) for p in ("base3", "trit2")}
        packed = run("init", init_packed)
        tuned = run("autotune", phase_autotune, torch, np, cfg, model,
                    packed["base3"], card)
        runs = run("serve", phase_serve, torch, np, cfg, model, packed)
        parity = run("parity", phase_parity, torch, np, cfg, model,
                     packed["base3"])
        del packed["trit2"]
        sched, sched_parity = run("sched", phase_sched, torch, np, cfg,
                                  model, packed["base3"])
        sanitized = run("sanitize", phase_sanitize, torch, np, cfg, model,
                        packed["base3"])
        mesh = run("mesh", phase_mesh, torch, np, cfg, model,
                   packed["base3"], card)
        int8kv = run("int8-kv", phase_int8_kv, torch, np, cfg, model,
                     packed["base3"])
        long = run("long", phase_long, torch, np, cfg, model,
                   packed["base3"])
        fid = run("fidelity", phase_fidelity, torch, np, cfg,
                  packed["base3"], card, layer=False)
        del packed
        torch.cuda.empty_cache()
        cim_cases = run("cim-kernel", phase_cim_kernel, torch, cfg)
        # the float weights of the same seeded init, for the exact mode
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        exact = run("exact", phase_exact, torch, np, cfg, model, params,
                    cim_cases)
        del params
        torch.cuda.empty_cache()
        models = {arch: run(f"models {arch}", phase_model, torch, np,
                            arch) for arch in MODEL_ARCHS}
        frontend = run("frontend", phase_frontend, torch, np)
        torch.cuda.empty_cache()
        moe = run("moe", phase_moe, torch, np)
        recurrent = {arch: run(f"recurrent {arch}", phase_recurrent, torch,
                               np, arch) for arch in REC_ARCHS}
        cross = {arch: run(f"cross {arch}", phase_cross, torch, np, arch)
                 for arch in CROSS_ARCHS}
        cells = run("dryrun", phase_dryrun, torch, np, cfg, model)
        train = run("train", phase_train, torch, np, card, parity=False)
        families = run("train-families", phase_train_families, torch, np,
                       card, parity=False)
        dr = dict(cells=cells, cli=run("dryrun-cli", dryrun_cli_report,
                                       cli))
        par = run("parity-cpu", parity_result, worker)
    finally:
        stop(cli)
        stop(worker)
    par["card"] = parity_card_s
    attach_parity(par, fid, train, families)

    details = dict(card=card, device=torch.cuda.get_device_name(0),
                   harness_floor_ms=floor_ms, cases=cases, serve=runs,
                   parity=parity, paged_kernel=paged, sched=sched,
                   sched_parity=sched_parity, long=long, cim_cases=cim_cases,
                   exact=exact, models=models, fidelity=fid,
                   frontend=frontend, moe=moe, int8_kv=int8kv,
                   recurrent=recurrent, cross=cross, train=train,
                   train_families=families, autotune=tuned,
                   sanitize=sanitized, analysis=analysis, mesh=mesh,
                   dryrun=dr, parity_worker={k: par[k] for k in (
                       "card", "seconds", "waited_s")}, phases=phases,
                   seconds=time.monotonic() - t_start)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print("[models] summary " + json.dumps({
        arch: {key: m[key] for key in (
            "prefill_ms", "decode_step_ms", "tok_per_s",
            "packed_weight_bytes", "decode_step_bound_ms",
            "decode_device_idle_share")} for arch, m in models.items()}))
    print(f"[done] {details['seconds']:.1f} s")
    print(card)
    print("[moe] summary " + json.dumps(dict(
        init_pack_s=moe["init_pack_s"], init_peak_bytes=moe[
            "init_peak_bytes"], **{key: moe["bucket"][key] for key in (
                "prefill_ms", "decode_step_ms", "tok_per_s",
                "decode_step_bound_ms", "decode_device_idle_share")},
        window_wall_s=moe["window_run"]["wall_s"],
        window_long_prefill_ms=moe["window_run"]["long_prefill_ms"],
        window_kv_bytes_pool=moe["window_run"]["kv_bytes_pool"])))
    print("[int8-kv] summary " + json.dumps(dict(
        kv_bytes_pool_int8=int8kv["kv_bytes_pool_int8"],
        kv_bytes_pool_float=int8kv["kv_bytes_pool_float"],
        **{f"bucket_{kv}_{key}": int8kv["bucket"][kv][key]
           for kv in ("float", "int8")
           for key in ("prefill_ms", "decode_step_ms", "tok_per_s",
                       "decode_step_bound_ms", "decode_device_idle_share")},
        token_agreement=int8kv["bucket"]["token_agreement_with_float_kv"])))
    print("[recurrent] summary " + json.dumps({
        arch: dict(packed_weight_bytes=r["packed_weight_bytes"],
                   parity_worst_rel_err=r["parity"]["worst_rel_err"],
                   **{key: r["bucket"][key] for key in (
                       "matmuls_per_forward", "prefill_ms", "decode_step_ms",
                       "tok_per_s", "decode_step_bound_ms",
                       "decode_device_idle_share")})
        for arch, r in recurrent.items()}))
    print("[cross] summary " + json.dumps({
        arch: dict(packed_weight_bytes=r["packed_weight_bytes"],
                   init_pack_s=r["init_pack_s"],
                   cross_kv_bytes_per_slot=r["cross_kv_bytes_per_slot"],
                   parity_worst_rel_err=r["parity"]["worst_rel_err"],
                   launcher_tok_per_s=r["launcher"]["tok_per_s"],
                   **{key: r["bucket"][key] for key in (
                       "matmuls_per_prefill", "matmuls_per_step",
                       "encoder_ms", "prefill_ms", "decode_step_ms",
                       "tok_per_s", "decode_step_bound_ms",
                       "decode_device_idle_share")})
        for arch, r in cross.items()}))
    print("[train] summary " + json.dumps(train_summary(train)))
    print("[train-families] summary " + json.dumps(
        train_families_summary(families)))
    print("[autotune] summary " + json.dumps(autotune_summary(tuned)))
    print("[sanitize] summary " + json.dumps(
        {k: [r["transfers"], r["chunks"], r["new_plans"], r["builds"]]
         for k, r in sanitized.items()}))
    print("[mesh] summary " + json.dumps(mesh_summary(mesh)))
    print("[dryrun] summary " + json.dumps(dryrun_summary(dr)))
    kernels = (kernel_summary(cases, runs, cfg, models, moe, int8kv,
                              recurrent, cross)
               + [kernel_summary_paged(paged, sched, models, long,
                                       frontend),
                  kernel_summary_cim(cim_cases, exact, cfg, train),
                  kernel_summary_threefry(fid, train, families)])
    for k in kernels:
        # the meshed runs' own counts (zeroed just before, read after)
        if k["name"] == "ternary_matmul":
            k["launches_mesh"] = mesh["serve"]["meshed"]["launches"][
                "ternary_matmul"]
            k["launches_mesh_sched"] = {
                kind: mesh["sched"][kind]["meshed"]["launches"][
                    "ternary_matmul"] for kind in ("dense", "gather")}
        if k["name"] == "ternary_matmul_int8":
            k["launches_mesh"] = mesh["domains"]["int8"]["meshed"][
                "launches"]["ternary_matmul_int8"]
        if k["name"] == "cim_mac":
            k["launches_mesh"] = mesh["domains"]["exact"]["meshed"][
                "launches"]["cim_mac"]
            k["launches_mesh_train"] = mesh["train_families"]["exact"][
                "launches"]["cim_mac"]
        if k["name"] == "paged_attention":
            # the meshed PagedScheduler reads through the gather path
            k["launches_mesh"] = mesh["sched"]["gather"]["meshed"][
                "launches"]["paged_attention"]
        if k["name"] == "threefry":
            k["launches_mesh"] = mesh["train"]["threefry_launches"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
