#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only tp_cards      # 2 or more cards: phase 14
    python3 chip_smoke.py --only tp_families   # 2 or more cards: phase 15
    python3 chip_smoke.py --only tp_spec_mm    # 2 or more cards: phase 16
    python3 chip_smoke.py --only tp_fleet      # 4 or more cards: phase 17
    python3 chip_smoke.py --only data_axis     # 4 or more cards: phase 18
    python3 chip_smoke.py --only train_mesh    # 4 or more cards: phase 19

Phases (each raises on failure; the script exits non-zero and prints no
result line when any phase fails or when no CUDA device is present):

1. device — the card's name and power limit (nvidia-smi);
2. build  — compile every hand-written kernel from ``src/repro_torch``
   (one nvcc per source, started together) and print the build time;
3. kernel — hold each kernel against its plain PyTorch version on the
   card at the main paths' shapes, then time kernel, plain version and
   a PyTorch library call of the same function, beside the bound the
   card's data sheet gives for the same work: the paged decode attention
   (f32/bf16/f16 pools, and int8/fp8 pools with their scales; and at the
   edges of its split over 16 blocks, for all five pool types with and
   without the fold: lengths 0, 1, 15, 16, 17, bs - 1, bs, bs + 1, 300,
   511 and T*bs over tables out of order, each row alone bit-identical
   to its row in the batch, the null block inert, the length-0 row the
   mean of its table's V rows; and as the chunked prefill calls it, the
   C = 64 queries of one chunk over one broadcast table, lengths
   449..512, each query alone bit-identical to its row; and as
   speculative verify calls it, 4 slots x 5 queries with a table each,
   positions 72, 295, 506, 0, f32/int8/fp8 pools, each query alone
   bit-identical to its row; and on a corrupted pool, one NaN row in
   two tables, in f32 K/V, int8 scales and fp8 codes: every head of the
   rows that attend it NaN, every other row bit-identical), the dense
   decode attention (each row alone bit-identical to its row in the
   batch; the chunked prefill's stride-0 cache at C = 64), and the decode
   GEMV at the four shapes of one full-width layer (f32, bf16 and int8
   weights; B = 4 bit-identical to four B = 1 calls); first, the timing
   floor: a one-element ``add_`` timed the same way;
4. engine — serve full-width smollm-135m (random weights from seed 0)
   through ``LPUEngine``: the streamed paged kernel, its eager twin
   (``graphs=False``: the same windows launched op by op from Python),
   the gather oracle, and a run that preempts with 4-step windows; the
   greedy streams must agree, the kernel must have launched once per
   layer per decode step, and both twins are profiled (wall against
   device ms per token, the profiler's count of kernel 1 against the
   launch registry's); then the prefill paths: (a) the 8 prompts and a
   448-token one in chunks of 64 against the monolithic run (no decode
   stall), each beside its eager twin, (b) the same on the gather
   oracle (no launch), (c) 4 prompts
   sharing a 256-token system prompt with the prefix cache on against
   off, (d) two identical 256-token prompts at once (copy-on-write), (e)
   chunks with a pool small enough to preempt; greedy streams equal, or
   apart only where the model's top-2 gap is at most 1e-4 (a near tie),
   the pool balanced, and kernel 1 launched exactly once per layer per
   decode step, per chunk and per prefix tail; plus the last row of the
   448-token prompt by both prefill paths; then the time to first
   token of the 448-token prompt on a warmed engine, monolithic (bucket
   512) and in chunks of 64, on captured programs and on the eager twin
   (median of 5 requests from ``submit`` to the first token's
   ``stream_cb``, and torch.profiler's device time of one prefill); then
   (f) the same traffic on
   an int8 and an fp8 pool, every run prefilled in chunks of 64: kernel
   1 against the gather oracle of the same pool, prefix on against off,
   a pool of 7 blocks of 32 that preempts against the uncontended run,
   exact launches, the pool balanced and its bytes its leaves'; the
   common prefix with the f32 pool's streams and the bytes moved per
   step against f16 reported; and (g) speculation with draft_k 4 on
   prompts that repeat a motif: the n-gram drafter, an oracle drafter
   (all accepted), an adversarial one (all rejected), the model drafter
   (a reduced smollm-135m over the full vocabulary), the n-gram drafter
   on the int8 pool and with chunks of 64 and the prefix cache, each
   against its plain twin, kernel 1 launched once per layer per decode
   step, verify round, chunk and prefix tail;
5. chain — the C1 streamlined chain (``core/streamline.py``) at full
   width: 4 prompts prefilled by the model, then 8 teacher-forced decode
   steps of ``decode_layer`` stacked over the 30 layers, in six variants
   (paged stream, paged gather, dense, int8 pool, fp8 pool, int8
   weights), each with kernels and with the plain versions; logits are
   held against each other and (fp variants) against the model's own
   decode, launches per step must be exact; plus one full-width
   ``chunk_prefill_layer`` (C = 64) against 64 sequential decode steps,
   through kernel 1 and through kernel 2's broadcast cache, and
   a torch.profiler pass of the stream and the dense variants (device ms
   per step of each port kernel);
6. rwkv — kernel 4 (the WKV recurrence) bit-identical to its plain
   version at the reference test's shapes, the decode shape
   (4, 1, 64, 64), a prefill length (1, 512, 64, 64), dh 32, 64, 100
   and 128 and B*H = 1, timed at the decode and prefill shapes (at the
   prefill length
   beside the port's chunked form too); then full-width rwkv6-7b, its
   depth cut to 16 of 32 layers since phase 13 joined the run (f32,
   random weights from seed 0, ~15 GB) served through
   ``LPUEngine``: 8 prompts x 32 new tokens on 4 slots, exactly one kernel
   launch per layer per device decode step and none in prefill, a torch.profiler
   pass, and a teacher-forced replay of the streams with the kernel and
   with its plain version (logits within 1e-4, greedy tokens equal to the
   plain oracle's argmax wherever its top-2 gap exceeds 1e-4);
7. jamba — after the rwkv phase's model is freed: kernel 5 (the
   selective scan), both entries (a: da, bx given; b: fused, da and bx
   formed in registers from dt, x, a, b) bit-identical to their plain
   versions at the reference test's shapes, the decode shape
   (4, 1, 8192, 16) and the prefill shapes (1, 64, 8192, 16) and
   (1, 512, 8192, 16), timed at the last three, entry (b) beside the
   path it replaced (PyTorch's producers of da and bx, then entry a);
   then jamba-v0.1-52b at full width, its depth cut from 32 layers to one
   super-block of 8 (attention at index 4, mamba at the other seven, MoE
   on the odd layers; 13.3e9 parameters, 53 GB in f32: the full depth
   does not fit the card), random weights from seed 0, served through
   ``LPUEngine`` from the dense cache: 8 prompts x 32 new tokens on 4
   slots, exactly 7 launches of entry (b) per device decode step and per
   prefill, a torch.profiler pass, and a teacher-forced replay of the
   streams in the engine's batching with the kernel and with its plain
   version (logits within 1e-4, greedy tokens equal to the plain
   oracle's argmax wherever its top-2 gap exceeds 1e-4);
8. opt (h), the paper's own models, run between the chain and rwkv
   phases — full-width opt-1.3b (24 layers, d 2048, 32 heads over 32 kv
   heads of 64; random weights from seed 0, every bias and the learned
   positions refilled non-zero from a seeded generator): (h1) in f32
   through ``LPUEngine`` with the smollm engine phase's traffic, kernel
   1 against the gather oracle, a pool that preempts, and chunks of 64
   with the prefix cache on 4 prompts sharing a 256-token system prompt
   against the monolithic run (streams equal or apart only at a top-2
   gap <= 1e-4, kernel 1's launches exact, the pool balanced); (h2) the
   C1 chain over its 24 layers at 4 rows, stream and dense variants
   (kernels 1-3, the gemvs with their bias) against their plain
   versions and the model's decode, exact launches and a profile; (h3)
   kernel 1 at the protocol's shape (B 1, H = G = 32, length 1040, bf16
   pool, dh 64 and 128) and kernel 3 at opt-1.3b's four gemvs with bias
   (1 and 4 rows, f32 and bf16), each checked and timed beside its plain
   version, its library call and its bound; (h4) the paper's protocol
   at batch 1 in bf16 (1 slot, max_seq 2048, 8-step windows, a 32-token
   prompt; opt-1.3b and full-width opt-6.7b, out OPT_OUT tokens, each
   freed before the next loads), on captured windows and on the eager
   twin (OPT_EAGER_OUT tokens), streams equal: wall and device ms per
   token (torch.profiler
   over 64 decode steps at the middle of the output), the busy share,
   bytes per token and bandwidth use, beside the paper's figures,
   labelled as the paper's; and the time to first token of the
   protocol's 32-token prompt (bucket 128) on each warmed twin;
9. fleet, run after the engine phase on its model — ``MultiRingEngine``
   over two engines of full-width smollm-135m (f32, seed 0) on the one
   card, sharing its weight tensors: 4 slots each, max_seq 512, blocks
   of 128, kernel 1 streamed, the engine phase's 8 prompts x 32 new
   greedy tokens, a heartbeat timeout of 4 virtual seconds, straggler
   monitors seeded as the serve CLI seeds them on the card (no prior:
   their warm-up takes the first measured steps): (i) fault free, no
   straggler flagged; (ii) chaos ``ring@2,stall@3:1,nan@5,corrupt@8``; (iii)
   ``corrupt@4`` (caught as ``nan_logits``: the NaN block reached the
   logits through kernel 1); (iv) ``nan@3`` in 4-step windows with a
   second window in flight; (v) ``ring@2`` with ``max_migrations=0``
   (structured failures); (vi) the eager twin of (ii), its streams and
   events equal; (vii) ``affinity="prefix"`` with the prefix cache on
   the 4 prompts sharing a 256-token system prompt, all routed to the
   ring that owns it, with prefix hits.  Every stream (a failed one up
   to its length) agrees with (i)'s, every pool is balanced and finite
   after the drain, kernel 1 ran once per layer per device decode step
   on every ring, every graph run replayed its programs, and every
   ``reset()`` kept the cache tensors' storage and the ring's captures;
   then the median wall of ``reset()`` on a warmed ring with 4 requests
   in flight;
10. front end, run after phase 9 on its model — the async serving front
   end (``AsyncFrontend``) over fresh engines of full-width smollm-135m
   (the engine phase's: 4 slots, max_seq 512, blocks of 128, kernel 1
   streamed, on graphs, chunks of 64), each with its captures inside its
   wall, replaying one bursty two-tenant trace (``serving/traces.py``:
   32 requests, Pareto arrivals at 200 requests/s, a 256-token system
   prompt per tenant, tails of 4-64 tokens, 4-32 new tokens) at its own
   arrival times: (a) budget off, every stream equal to the blocking
   run's of the same prompts; (b) the SLO budget on (5 ms a step, the
   scheduler seeded as the serve CLI seeds it on the card, with no
   prior, chunks up to 512), streams equal to (a)'s, the plans and the EWMA's
   trail recorded; (c) ``max_pending=4`` with one stream cancelled after
   3 tokens and the rejected submits retried after ``join()``, the
   others equal to their blocking streams; (d) a two-ring fleet with
   prefix affinity and the prefix cache behind the front end, its
   telemetry into a jsonl file read back and validated, each ring's
   window deltas summing to its counters.  Streams equal or apart only
   at a top-2 gap <= 1e-4, kernel 1's launches exact per replay, every
   pool balanced; TTFT and ms/token p50/p99 from the request records.
11. families, run last, each model drawn on the card from seed 0 and
   freed before the next — kernel 1 at the three GQA shapes the last
   families give it (granite H 24 / G 8, dh 64, f32; llama4 40 / 8, dh
   128, bf16; llava 56 / 8, dh 128, bf16): at its split's edges on the
   engine's pool dtype and an int8 pool, then at the decode shape
   against its plain version, timed beside it, the library call and
   its bound; (a) granite-moe-3b-a800m at full width, depth cut to 16
   of 32 (to make room for phase 13), f32,
   through ``LPUEngine`` on graphs (8 prompts of 2-64 tokens x 32 new,
   4 slots, max_seq 512, blocks of 128) and its eager twin: streams
   equal or apart only at a top-2 gap <= 1e-4, kernel 1 exact per
   replay, pools balanced; the captures' time, the wall of a stretch of
   pure decode steps on the warmed engine, one decode step's device
   time (its 1-step window replayed alone), its kernels, and the
   device time of the MoE layers alone (the expert loop); (b)
   llama4-maverick-400b-a17b cut to depth 2 (a dense and an MoE layer
   with its shared expert), bf16, 4 prompts x 16 new, the same gates
   (bf16 near ties at 3e-2); (c) llava-next-34b cut to depth 8, bf16,
   the same through the engine, then 2880 seeded patch embeddings and
   16 text tokens through the prefill step of ``core/steps.py`` and 16
   serve steps, each token equal to a recompute twin's (a prefill over
   the grown sequence) or apart at a bf16 near tie, the prefill's
   device ms; (d) whisper-tiny, f32, 4 rows of seeded (1500, 384)
   frames and 4-token prompts through the prefill step and 32 serve
   steps, each token equal to its recompute twin's or apart at a
   top-2 gap <= 1e-4, wall and device ms per serve step.
12. training, after phase 11 has freed its models — full-width
   smollm-135m, f32 masters and compute, TF32 off, random weights from
   seed 0, through ``repro_torch.launch.train.run_training`` (eager
   autograd, AdamW, the synthetic data stream): (a) 30 steps at batch 8
   x seq 512, lr 6e-4, cosine: every loss finite, the mean of the last
   5 below the mean of the first 5 by more than 0.5; (b) the same run
   checkpointing every 8 steps under a temporary directory, crashed by
   ``FailureInjector([12])`` and resumed from its latest checkpoint:
   its losses from step 8 on equal (a)'s at rtol 1e-4; (c) one step
   with ``accum_steps`` 1 against 4 on the same weights and batch,
   losses within 1e-5, then 2 warm + 5 timed steps on the train step
   (wall per step, the optimizer's device ms by CUDA events, peak
   memory), one step under torch.profiler (device ms and kernels) and a
   checkpoint save; (d) no launch of any of the five kernels across the
   phase, and each kernel wrapper, given an input on the card that
   requires grad, raises.
13. tensor parallelism over the ESL ring, after phase 12, the parent's
   cached blocks freed first — two ranks (processes spawned by
   ``repro_torch.core.dist.run_ranks``, placement ``shared_card``) share
   the card over gloo, every collective staged through pinned host
   memory, the steps eager (a gloo collective cannot be captured); the
   ranks load the kernel libraries the parent built.  Each rank draws
   only its shard of the tp=1 weights the earlier phases drew
   (``weights.init_shard``: the tp=1 values layer by layer, stored at
   the ring's layout and sliced at once; OPT's biases and positions
   redrawn the same way, ``weights.redraw_shard``): (a) full-width
   opt-1.3b (24 layers, d 2048, 32 heads of 64, f32) with (h1)'s 8
   prompts x 32 new on 4 slots, max_seq 512, blocks of 128, in ESL
   overlap (its blocking runs are phase 14's, on NCCL); (b) full-width
   smollm-135m in blocking (3 kv heads padded to 4: rank 1's second kv
   head a pad head, whose query heads' wq columns and wo rows must be
   zero) with the engine phase's prompts.  Kernel 1 is held against its
   plain version at each rank's shapes (opt: 16 query and 16 kv heads of
   64; smollm: 6 and 2), then every run's greedy streams must be the
   same on both ranks and equal the tp=1 engine's (phase (h)'s and the
   engine phase's) or part only at a top-2 gap <= 1e-4 of the tp=1
   model, with kernel 1 launched exactly n_layers x (decode steps +
   chunks) on each rank; a ``{"tp": ...}`` line gives each run's wall,
   tokens/s, decode steps, kernel 1's launches per rank, the ring's
   collectives, hops, host-staged bytes per decode step and host seconds
   inside the collectives, the backend, ``graphs: false`` and the card's
   name and power limit.  The ranks share one card, time-sliced: the
   walls say nothing of scaling.  (c) jamba-v0.1-52b at full width cut
   to one super-block (7 mamba layers, 1 attention, 4 MoE), f32, tp 2
   in ESL overlap, 2 prompts x 8 new: kernel 5's fused entry held
   against its plain version at each rank's 4096 channels, launched
   exactly 7 x (decode steps + prefills) on each rank, and the streams
   equal to the tp=1 engine's (the parent's, eager, before the spawn)
   or apart only at a top-2 gap <= 1e-4.  (f32: jamba with random
   weights in bf16 parts from its own tp=1 stream by more than the bf16
   near-tie rule allows; PERF.md §6, PR 29.)  Before the spawn, (d)
   jamba-v0.1-52b whole: rank 0's shard at tp 2 in bf16 (51.6 GB) drawn
   on the card alone, its peak above the shard under two tp=1 MoE
   layers.
14. the ring on its own cards, on a machine of 2 or more cards (on one
   card it prints that it needs 2 or more cards and did not run;
   ``python3 chip_smoke.py --only tp_cards`` runs the kernels' build and
   this phase alone) — ``nvidia-smi topo -m`` and every card's name and
   power limit; (d) kernel 1 at the ranks' heads (MHA, dh 128, bf16
   pool, B 1: opt-66b's 36 and 18 heads at length 1040, GPT3-20B's 24
   and 12 at length 160) against its plain version and timed beside it,
   the library call and its bound; the tp=1 references on cuda:0
   (opt-1.3b in f32 with (h1)'s traffic on graphs; GPT3-20B in bf16
   through the paper's protocol, 32 in and 256 out); then a ring of 2
   and of 4 ranks (``run_ranks`` placement ``card_per_rank``: rank r on
   ``cuda:r``, NCCL, every step of every engine replayed from CUDA
   graphs, each rank drawing only its shard): (a) full-width opt-1.3b in
   f32 with (h1)'s traffic in ESL overlap, in blocking and in blocking
   with a prefill in chunks of 64 (the chunk program captured too), and
   at tp 2 their eager twins: streams equal to tp=1's or apart only at a
   top-2 gap <= 1e-4, kernel 1's launches exact on every rank (n_layers
   x (decode steps + chunks)), every run replayed, nothing staged
   through the host, the graphs' collectives equal to the eager twin's
   and, at tp 2, to phase 13's count for the same traffic (overlap
   13922; blocking 3755 with its one-time gathers of parameters); (b)
   full-width GPT3-20B in bf16 through the protocol (32 in, 256 out) in
   overlap and in blocking: ms/token of wall and of device per rank
   (torch.profiler over 64 decode steps, NCCL's kernels apart), the
   speed-up per doubling from tp 1 beside the paper's 1.75 (LPU) and
   1.38 (DGX), streams equal to tp=1's or apart at a bf16 near tie seen
   from both sides (at the first token apart, both tokens within 3e-2 +
   3e-2 x |top-1 logit| of the top of the ring's logits and of tp=1's);
   (c) full-width opt-66b in bf16 (no card holds it whole) through the
   protocol, 2016 new in overlap and 512 in blocking: ms/token of wall
   and device, bandwidth use and peak memory per card beside the
   paper's 22.2 ms and the GPU's 0.649, tp 2's blocking stream held to
   its overlap stream and tp 4's streams to tp 2's overlap stream (apart
   only at such a near tie).  A ``{"tp_cards": ...}`` line.
15. rwkv, mamba and the MoE over the ring on cards of their own, on a
   machine of 2 or more cards (``python3 chip_smoke.py --only
   tp_families`` runs the kernels' build and this phase alone) — (e)
   kernels 4 and 5 (fused) at the ranks' shapes (rwkv6-7b's 32 and 16
   heads of 64, jamba's 4096 and 2048 channels of 16 states; 1 and 4
   rows) bit-equal to their plain versions and timed beside them with
   their bounds; the tp=1 references on cuda:0, on graphs, in f32 (jamba
   at 8 layers, rwkv6-7b whole, granite-moe-3b-a800m at 16 layers); then a ring of 2 ranks on their own cards (NCCL,
   steps on graphs, each rank drawing only its shard): (a) jamba-v0.1-52b
   whole (32 layers, bf16, 51.6 GB a card) in ESL overlap and in
   blocking, batch 1, 32 in and 256 out: ms/token of wall and of device
   per rank (torch.profiler over 32 decode steps, NCCL's kernels
   apart), the bound (the bytes a card reads a step over its
   bandwidth, and were only the routed experts read), peak memory per
   card, kernel 5's launches per rank exact, the eager twin's first 16
   tokens equal, where blocking's stream first parts from overlap's
   (reported: jamba in bf16 parts from itself under another order of
   sums); then 4 prompts x 32 new at 4 slots; (b) jamba at 8 layers,
   (c) rwkv6-7b whole (kernel 4 launched 32 x decode steps on each
   rank) and (d) granite at 16 layers (kernel 1 exact), each in f32
   against tp=1, apart only at a top-2 gap <= 1e-4.  A
   ``{"tp_families": ...}`` line.
17. the mesh fleet and the front end over the ring, on a machine of 4
   or more cards (``python3 chip_smoke.py --only tp_fleet`` runs the
   kernels' build and this phase alone; on fewer cards it prints that it
   did not run) — rank r on ``cuda:r`` over NCCL, every engine step on
   graphs, each rank drawing only its shard at its place in its
   sub-ring: (a) full-width opt-1.3b in f32 (blocking, chunks of 64) on
   phase 9's traffic, 8 prompts x 32 new, three ways: tp=1 on cuda:0, a
   lone ring of tp 2 on cards 0-1, the mesh fleet of 2 rings x tp 2 on
   cards 0-3 (``MultiRingEngine(..., ring, ring_size=2)``, one host
   agreement a round over a gloo group); the fleet's streams tp=1's (or
   apart at a top-2 gap <= 1e-4), routes balanced and the same on every
   rank, kernel 1 exact on every rank, every run replayed, each
   program's collectives per replay the lone ring's, none on the world
   group; tokens/s over the fleet's wall beside the lone ring's; (b)
   ``nan@3:0,ring@5:1`` with ``max_migrations=1`` on a fresh fleet:
   orphans migrate across processes, survivors equal to (a)'s, the
   requests out of migrations structured failures, ``fleet_counters()``
   the same on every rank, every reset in place with no new capture;
   (c) phase 10's trace through the front end on world rank 0 over the
   lone ring and over the fleet, budget off and on: TTFT from arrival
   and ms/token p50/p99, tokens/s, rejections, the orders' crc32 the
   same on every rank, streams the blocking run's; (d) full-width
   opt-66b in bf16 as 2 rings x tp 2 (~66 GB a card): the same 4 prompts
   of 32 tokens on both rings x 128 new at 4 slots, both rings' streams
   equal, fleet tokens/s, ms/token per ring, peak memory per card,
   kernel 1 exact on every rank, beside the single ring at tp 2 (measured
   in another run).  A ``{"tp_fleet": ...}`` line.
18. the data axis for serving, on a machine of 4 or more cards
   (``python3 chip_smoke.py --only data_axis`` runs the kernels' build
   and this phase alone) — a ``("data", "model")`` grid of data 2 x
   model 2, rank (d, m) on ``cuda:(2d + m)`` over NCCL, the serving
   steps (``core/steps.py``) eager, each rank drawing only its shard;
   beside it the twin, the model ring of tp 2 on cards 0-1 (no data
   axis): kernel 5's fused entry at a grid rank's channels against its
   plain version on cuda:0 and timed, and at every grid rank's decode
   and prefill shapes; (a) opt-1.3b f32, batch 8 over data, 32 in x 32
   steps: the streams tp=1's and the twin's (or apart at a top-2 gap
   <= 1e-4), one all-gather a step on the data ring; (b) jamba-v0.1-52b
   with its KV sequence over data and its experts over data x model:
   f32, one super-block, 8190 in x 8 steps across the shard boundary,
   the stream the twin's, kernel 5 exact on every rank; bf16, all 32
   layers at long_500k (524288 positions, batch 1) on the grid and the
   twin: ms a step over 64 steps, device ms a step (torch.profiler over
   16 more, NCCL apart), peak memory a card while serving (the draw's
   peak apart) and weight bytes a card, the bytes a step reads a card
   and their bound; (c) llama4-maverick with its
   experts over data x model: f32, 2 layers, 4 rows of 16 x 8, the
   streams the twin's; bf16, 8 layers at 4 rows: ms a step, peak a card.
   A ``{"kernels": [...]}`` line (kernel 5's grid launches) and a
   ``{"data_axis": ...}`` line.
19. training on the mesh, on a machine of 4 or more cards (``python3
   chip_smoke.py --only train_mesh`` runs this phase alone; training
   launches no kernel, so none is built) — a ``("data", "model")`` grid
   of data 2 x model 2, rank (d, m) on ``cuda:(2d + m)`` over NCCL,
   eager autograd through the collectives' adjoints, FSDP over
   ``data``: (a) the twin: opt-6.7b at full width cut to 4 of 32
   layers, TF32 off, 8 x 512, ESL blocking, 3 AdamW steps on the grid
   against tp 1 on cuda:0, in f32 and again with every float in f64:
   losses and global gradient norms at rtol 1e-5, step 1's gradients
   gathered and relaid to tp 1 (the padded vocab rows cut) at 1e-9 x
   each leaf's max in f64 and 1e-2 in f32, where the grid's split sums
   round apart from the twin's (the key biases' round-off gradients
   below 1e-6 x the tree's max on both), the parameters after step 3
   with at most 1e-3 of a leaf's elements past 1e-9 x its max in f64
   and every one within 2 x lr a step, every replicated leaf bit-equal
   on its ring; (b) opt-6.7b whole, f32
   masters, bf16 compute, remat block, 8 x 2048, 20 steps in blocking
   and in overlap: the last 5 steps' mean loss below the first 5's; ms
   a step (wall, and rank 0's device ms and NCCL's share over one more
   step), tokens/s, ``mfu_bf16``, peak memory and state bytes a card,
   one step's collectives and received bytes by kind on each ring;
   (c) the elastic restart: (a)'s model, 8 steps on the grid
   uninterrupted, then with a checkpoint at step 4 (rank 0 writes the
   plan's global tensors) and a crash at step 6, resumed on data 1 x
   model 2 (cards 0-1): the tail at rtol 1e-4.  A ``{"train_mesh":
   ...}`` line.

Every engine runs its fused decode windows, verify rounds, monolithic
prefills, prefill chunks, prefix tails, first-token sampling and
copy-on-write block copies as replays of CUDA graphs captured on first
use (``repro_torch/serving/graphs.py``; a recurrent stack's exact-length
prefill stays eager); a served run that ran one of these steps without
replaying its program fails.  A replay adds the launches its capture
made to the kernels' counters, so every exact-launch gate counts per
replay.

A ``[time]`` line closes each phase and one gives the total.  The last
lines are a ``{"kernels": [...], "floor_ms": ...}`` line, an
``{"engine": ...}`` line, a ``{"chain": ...}`` line, an ``{"rwkv": ...}``
line, a ``{"jamba": ...}`` line, an ``{"opt": ...}`` line, a
``{"ttft": ...}`` line (smollm-135m's and (h4)'s times to first token,
graphs and eager twin, with the card's name and power limit), a
``{"fleet": ...}`` line (phase 9 per run: wall, tokens/s over the
fleet's wall, ``fleet_counters()``, straggler events; the reset wall;
the card's name and power limit), a ``{"frontend": ...}`` line (phase 10
per run: counts, TTFT and ms/token p50/p99, tokens/s over the run's
wall, captures in the run; for (b) the plans and the EWMA), a
``{"families": ...}`` line (phase 11: kernel 1 at each family's shape,
each model's engine and twin, decode step, expert loop, llava's and
whisper's steps, the laps; the card's name and power limit), a
``{"train": ...}`` line (phase 12: the losses, the resume, ms per step,
one step's device ms and kernels, tokens/s, peak memory, the
optimizer's device ms, the checkpoint's save wall, ``mfu_f32``, the
card's name and power limit), a ``{"tp": ...}`` line (phase 13), on 2
or more cards a ``{"tp_cards": ...}``, a ``{"tp_families": ...}`` and a
``{"tp_spec_mm": ...}`` line (phases 14-16), on 4 or more a
``{"tp_fleet": ...}`` line (phase 17; phases 18 and 19 print their
own lines with ``--only data_axis`` and ``--only train_mesh``), the
nvidia-smi
line and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX: the
port stands alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# data-sheet HBM bandwidth (bytes/s) by the name nvidia-smi reports
BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
             ("H200", 4.8e12), ("H100", 3.35e12))
# data-sheet peak rates (op/s): f32 off the tensor cores, bf16/f16 dense
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 3e-2, "float16": 3e-2}

# main-path shapes of the paged kernel: smollm-135m at slots=4,
# max_seq=512, block_size=128 (T=4, dense-equivalent pool N=17)
B, H, G, DH, BS, T, N = 4, 9, 3, 64, 128, 4, 17
LENGTHS = (0, 77, 300, 511)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def bandwidth_for(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    raise RuntimeError(f"no data-sheet bandwidth known for {name!r}")


def kernel_inputs(torch, dev, q_dtype, kv_dtype, seed=0, fill=None):
    """Paged-attention inputs at the main path's shapes: ragged lengths
    (one row empty), table tails on the null block 0, block 0 filled
    with ``fill`` when given."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    q = rnd(B, H, DH, dtype=q_dtype)
    kp = rnd(N, BS, G, DH, dtype=kv_dtype)
    vp = rnd(N, BS, G, DH, dtype=kv_dtype)
    kn = rnd(B, G, DH, dtype=q_dtype)
    vn = rnd(B, G, DH, dtype=q_dtype)
    tables = torch.zeros((B, T), dtype=torch.int32)
    for b, n in enumerate(LENGTHS):
        used = -(-n // BS)
        tables[b, :used] = torch.arange(1 + T * b, 1 + T * b + used)
    if fill is not None:
        kp[0] = fill
        vp[0] = fill
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    return q, kp, vp, tables.to(dev), lengths.to(dev), kn, vn


def check_paged_kernel(torch, dev):
    """Kernel vs plain version on the card: f32/bf16/f16 pools, with and
    without the fold; the length-0 row without the fold is the mean of
    its table's V rows; block 0 scribbled must change no row that
    attends something.  Returns the largest error per dtype pair."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    errs = {}
    cases = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float16, torch.float16), (torch.float32, torch.bfloat16))
    for q_dt, kv_dt in cases:
        name = str(kv_dt).split(".")[-1]
        tol = TOL[name]
        key = f"q={str(q_dt).split('.')[-1]},pool={name}"
        errs[key] = 0.0
        for fold in (False, True):
            base = None
            for fill in (None, 1e30, -1e30):
                if fill is not None:
                    fill = min(fill, torch.finfo(kv_dt).max) if fill > 0 \
                        else max(fill, -torch.finfo(kv_dt).max)
                q, kp, vp, tb, ln, kn, vn = kernel_inputs(
                    torch, dev, q_dt, kv_dt, fill=fill)
                extra = dict(k_new=kn, v_new=vn) if fold else {}
                got = paged_decode_attention(q, kp, vp, tb, ln, **extra)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{key} fold={fold} fill={fill}: "
                                         "non-finite kernel output")
                if fill is None:
                    base = got
                    want = paged_decode_attention_ref(q, kp, vp, tb, ln,
                                                      **extra)
                    err = (got.float() - want.float()).abs().max().item()
                    if not torch.allclose(got.float(), want.float(),
                                          rtol=tol, atol=tol):
                        raise AssertionError(
                            f"{key} fold={fold}: kernel vs plain beyond "
                            f"rtol=atol={tol} (max abs error {err})")
                    errs[key] = max(errs[key], err)
                    if not fold:
                        # length-0 row: the mean of the V rows of its
                        # whole table (all on the null block here)
                        mean = gather_kv_pages(vp, tb)[0].float().mean(0)
                        got0 = got[0].float().reshape(G, H // G, DH)
                        if not torch.allclose(got0, mean[:, None].expand(
                                -1, H // G, -1), rtol=tol, atol=tol):
                            raise AssertionError(
                                f"{key}: length-0 row without a fold is "
                                "not the mean of its table's V rows")
                else:
                    # the null block is inert for rows that attend
                    # something (length > 0, or the fold)
                    keep = (ln > 0) | fold
                    if not torch.equal(got[keep], base[keep]):
                        raise AssertionError(
                            f"{key} fold={fold}: null block filled with "
                            f"{fill} changed the output")
    return errs


def time_ms(torch, fn, n_sets, iters=200, warmup=20, tries=3):
    """(device ms, host ms) of one call, cycling over ``n_sets`` input
    sets so the caches stay cold like the main path's per-layer pools.

    Host ms is the wall time per call launched back to back (Python
    dispatch included).  Device ms comes from CUDA events around the
    same calls queued behind a device-side sleep that outlasts their
    launching, so they run back to back on the card and the host's
    dispatch cost is hidden.  When the launching took longer than the
    sleep can have lasted (the host slowed down between the two loops),
    the calls may have been paced by the host, and the run is repeated
    behind a 4x longer sleep, up to ``tries - 1`` times.  That holds
    while the queued launches fit the launch queue: for a function of
    many small launches (a plain version) the device ms may be paced by
    the host, and is then an upper bound."""
    for i in range(warmup):
        fn(i % n_sets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i % n_sets)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    cycles = int(4e9 * host_s) + 1_000_000
    for _ in range(tries):
        torch.cuda._sleep(cycles)
        t1 = time.perf_counter()
        start.record()
        for i in range(iters):
            fn(i % n_sets)
        stop.record()
        queued_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        if queued_s < 0.9 * cycles / 2.0e9:   # the sleep's least length
            break
        cycles *= 4
    return start.elapsed_time(stop) / iters, host_s / iters * 1e3


def time_floor(torch, dev):
    """(device ms, host ms) of a call of known-trivial device work, a
    one-element ``add_`` on a tensor already on the card, through the
    same time_ms: the floor under every single-launch kernel's time."""
    t = torch.zeros(1, device=dev)
    return time_ms(torch, lambda i: t.add_(1.0), 1)


def time_paged_kernel(torch, dev, card_name):
    """Kernel, plain and library times at the main path's shapes (f32,
    with the fold, as decode calls it) and the data-sheet bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        SPLIT, dense_plan, paged_decode_attention)
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    q, kp, vp, tb, ln, kn, vn = kernel_inputs(torch, dev, torch.float32,
                                              torch.float32)
    pool_bytes = 2 * kp.numel() * kp.element_size()
    n_sets = sets_for(pool_bytes)
    pools = [(kp.clone(), vp.clone()) for _ in range(n_sets)]

    def kernel(i):
        paged_decode_attention(q, pools[i][0], pools[i][1], tb, ln,
                               k_new=kn, v_new=vn)

    def plain(i):
        paged_decode_attention_ref(q, pools[i][0], pools[i][1], tb, ln,
                                   k_new=kn, v_new=vn)

    S = T * BS
    valid = torch.arange(S, device=dev)[None, :] < ln[:, None]
    mask = torch.cat([valid, torch.ones((B, 1), dtype=torch.bool,
                                        device=dev)], 1)[:, None, None, :]

    def library(i):
        k = gather_kv_pages(pools[i][0], tb)
        v = gather_kv_pages(pools[i][1], tb)
        k = torch.cat([k, kn[:, None]], 1).transpose(1, 2)
        v = torch.cat([v, vn[:, None]], 1).transpose(1, 2)
        F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                       enable_gqa=True)

    times = timed(torch, {"ms": kernel, "plain_ms": plain,
                          "library_ms": library}, n_sets)
    # least work: q, the valid K/V rows, the new token, tables, lengths
    # read once and the output written once; 4*dh flops per q head per
    # attended position (score dot + P.V)
    item = 4
    rows = sum(LENGTHS)
    nbytes = item * (B * H * DH + 2 * rows * G * DH + 2 * B * G * DH
                     + B * H * DH) + 4 * (B * T + B)
    times["bound_ms"], times["bound_by"] = bound_for(
        nbytes, 4 * DH * H * (rows + B), "float32", card_name)
    L, stages = dense_plan(T * BS, DH, 4)
    times["plan"] = {"grid": [SPLIT, G, B], "cluster": [SPLIT, 1, 1],
                     "blocks": SPLIT * G * B, "tile_rows": L,
                     "stages": stages}
    return times


def bound_for(nbytes, ops, op_dtype, card_name):
    """(bound ms, what bounds it): the larger of the bytes over the
    data-sheet bandwidth and the operations over the data-sheet peak."""
    t_bytes = nbytes / bandwidth_for(card_name) * 1e3
    t_ops = ops / PEAK_OPS[op_dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def timed(torch, fns, n_sets, iters=None):
    """{"ms", "host_ms", ...} for each named function, as time_ms gives
    them; ``iters`` ({name: (iters, warmup)}) shortens the slow ones.  A
    slow one (a plain recurrence over hundreds of positions) launches
    more than the launch queue holds, so a longer sleep cannot keep
    the host's pace out of its device ms: it is timed behind one sleep,
    and its device ms is an upper bound."""
    out = {}
    for key, fn in fns.items():
        it, warm = (iters or {}).get(key, (200, 20))
        out[key], out[key.replace("ms", "host_ms")] = time_ms(
            torch, fn, n_sets, iters=it, warmup=warm,
            tries=1 if key in (iters or {}) else 3)
    return out


def sets_for(nbytes):
    """Input sets to cycle so the working set exceeds twice the L2."""
    return max(1, math.ceil(2 * 50e6 / nbytes))


def check_time_quantized_pool(torch, dev, card_name):
    """Kernel 1 with int8 and fp8 pools (f16 scales per row and kv head)
    against its plain version at the main path's shapes, with and without
    the fold; timed without the fold, as the chain calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    from repro_torch.serving.kv_cache import quantize_kv_rows
    out = {}
    for name, qdt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        q, kp, vp, tb, ln, kn, vn = kernel_inputs(torch, dev, torch.float32,
                                                  torch.float32, seed=3)
        kq, ks = quantize_kv_rows(kp, qdt, torch.float16)
        vq, vs = quantize_kv_rows(vp, qdt, torch.float16)
        err = 0.0
        for fold in (False, True):
            extra = dict(k_new=kn, v_new=vn) if fold else {}
            got = paged_decode_attention(q, kq, vq, tb, ln, k_scale=ks,
                                         v_scale=vs, **extra)
            want = paged_decode_attention_ref(q, kq, vq, tb, ln, k_scale=ks,
                                              v_scale=vs, **extra)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            if not torch.isfinite(got).all() or not torch.allclose(
                    got, want, rtol=TOL["float32"], atol=TOL["float32"]):
                raise AssertionError(f"{name} pool fold={fold}: kernel vs "
                                     f"plain beyond 1e-4 (max abs {e})")
            err = max(err, e)
        n_sets = sets_for(2 * (kq.numel() + 2 * ks.numel()))
        pools = [(kq.clone(), vq.clone(), ks.clone(), vs.clone())
                 for _ in range(n_sets)]
        S = T * BS
        mask = (torch.arange(S, device=dev)[None, :] <
                ln[:, None])[:, None, None, :]

        def kernel(i, pools=pools, q=q, tb=tb, ln=ln):
            k, v, a, b = pools[i]
            paged_decode_attention(q, k, v, tb, ln, k_scale=a, v_scale=b)

        def plain(i, pools=pools, q=q, tb=tb, ln=ln):
            k, v, a, b = pools[i]
            paged_decode_attention_ref(q, k, v, tb, ln, k_scale=a,
                                       v_scale=b)

        def library(i, pools=pools, q=q, tb=tb, mask=mask):
            k, v, a, b = pools[i]
            kf = gather_kv_pages(k, tb).float() * gather_kv_pages(
                a, tb).float()[..., None]
            vf = gather_kv_pages(v, tb).float() * gather_kv_pages(
                b, tb).float()[..., None]
            F.scaled_dot_product_attention(
                q[:, :, None], kf.transpose(1, 2), vf.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        t = timed(torch, {"ms": kernel, "plain_ms": plain,
                          "library_ms": library}, n_sets)
        rows = sum(LENGTHS)
        nbytes = (4 * 2 * B * H * DH + 2 * rows * G * (DH + 2)
                  + 4 * (B * T + B))
        t["bound_ms"], t["bound_by"] = bound_for(
            nbytes, 4 * DH * H * rows, "float32", card_name)
        t["max_abs_err"] = err
        out[name] = t
    return out


# kernel 1's split at its edges, at the main path's pool (bs 128, T 4):
# lengths on share and pool-block boundaries (300 and 511: shares of 19
# and 32 rows, the first crossing blocks), each row's blocks out of order
SPLIT_LENGTHS = (0, 1, 15, 16, 17, BS - 1, BS, BS + 1, 300, 511, T * BS)


def split_inputs(torch, dev, pool_dtype, seed=5, heads=(H, G, DH)):
    """(q, kp, vp, tables, lengths, kn, vn, scales) at SPLIT_LENGTHS, the
    rows' blocks drawn from a shuffled pool, table tails on the null
    block 0; an int8 / fp8 pool is quantized from an f32 one with f16
    scales (q stays f32).  ``heads``: (query heads, kv heads, dh)."""
    from repro_torch.serving.kv_cache import quantize_kv_rows
    hq, gk, dh = heads
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = len(SPLIT_LENGTHS)
    n_blocks = nb * T + 1
    quant = pool_dtype in (torch.int8, torch.float8_e4m3fn)
    q_dtype = torch.float32 if quant else pool_dtype

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    perm = torch.randperm(n_blocks - 1, generator=g, device=dev) + 1
    tables = torch.zeros((nb, T), dtype=torch.int32, device=dev)
    for b, n in enumerate(SPLIT_LENGTHS):
        used = -(-n // BS)
        tables[b, :used] = perm[b * T:b * T + used]
    kp, vp = rnd(n_blocks, BS, gk, dh), rnd(n_blocks, BS, gk, dh)
    scales = {}
    if quant:
        kp, ks = quantize_kv_rows(kp, pool_dtype, torch.float16)
        vp, vs = quantize_kv_rows(vp, pool_dtype, torch.float16)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=dev)
    return (rnd(nb, hq, dh).to(q_dtype), kp, vp, tables, lengths,
            rnd(nb, gk, dh).to(q_dtype), rnd(nb, gk, dh).to(q_dtype), scales)


SPLIT_POOLS = ("float32", "bfloat16", "float16", "int8", "float8_e4m3fn")


def check_paged_split(torch, dev, heads=(H, G, DH), pools=SPLIT_POOLS):
    """Kernel 1 at its split's edges, for f32, bf16, f16, int8 and fp8
    pools (or ``pools``), with and without the fold, at the main path's
    heads (or ``heads``: query heads, kv heads, dh): within tolerance of
    its plain version; each row alone bit-equal to its row in the batch;
    the length-0 row the mean of its table's V rows (v_new with the
    fold); the null block inert under +-1e30 fills (the largest stored
    values and f16 scales for a quantized pool).  Returns the largest
    error per case."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    hq, gk, dh = heads
    errs = {}
    for name in pools:
        pool_dtype = getattr(torch, name)
        tol = TOL.get(name, TOL["float32"])
        for fold in (False, True):
            key = f"{name},fold={fold}"
            q, kp, vp, tb, ln, kn, vn, sc = split_inputs(
                torch, dev, pool_dtype, heads=heads)
            extra = dict(k_new=kn, v_new=vn) if fold else {}
            got = paged_decode_attention(q, kp, vp, tb, ln, **sc, **extra)
            want = paged_decode_attention_ref(q, kp, vp, tb, ln, **sc,
                                              **extra)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got).all() or not torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol):
                raise AssertionError(f"split {key}: kernel vs plain beyond "
                                     f"rtol=atol={tol} (max abs {err})")
            errs[key] = err
            for b in range(len(SPLIT_LENGTHS)):
                one = {k: v[b:b + 1] for k, v in extra.items()}
                alone = paged_decode_attention(q[b:b + 1], kp, vp,
                                               tb[b:b + 1], ln[b:b + 1],
                                               **sc, **one)
                if not torch.equal(alone[0], got[b]):
                    raise AssertionError(f"split {key}: row {b} alone "
                                         "differs from its row in the batch")
            if fold:
                row0 = vn[0].float()[:, None].expand(-1, hq // gk, -1)
            else:
                v0 = vp[tb[0].long()].float()             # (T, BS, G, DH)
                if sc:
                    v0 = v0 * sc["v_scale"][tb[0].long()].float()[..., None]
                row0 = v0.reshape(-1, gk, dh).mean(0)[:, None].expand(
                    -1, hq // gk, -1)
            if not torch.allclose(got[0].float().reshape(gk, hq // gk, dh),
                                  row0, rtol=tol, atol=tol):
                raise AssertionError(f"split {key}: the length-0 row is not "
                                     + ("v_new" if fold else
                                        "the mean of its table's V rows"))
            for fill in (1e30, -1e30):
                kz, vz = kp.clone(), vp.clone()
                scz = {k: v.clone() for k, v in sc.items()}
                if sc:
                    big = 127.0 if pool_dtype == torch.int8 else 448.0
                    for v in scz.values():
                        v[0] = 65504.0 if fill > 0 else -65504.0
                else:
                    big = min(abs(fill), torch.finfo(pool_dtype).max)
                for t, val in ((kz, big if fill > 0 else -big), (vz, -big)):
                    t[0] = torch.full(t.shape[1:], val,
                                      device=dev).to(pool_dtype)
                out = paged_decode_attention(q, kz, vz, tb, ln, **scz,
                                             **extra)
                keep = (ln > 0) | fold
                if not torch.isfinite(out).all() or \
                        not torch.equal(out[keep], got[keep]):
                    raise AssertionError(f"split {key}: null block filled "
                                         f"with {fill} changed the output")
    return errs


# kernel 1 on a corrupted pool: one NaN row in the tables of two split
# edge rows (length 17 at its last position, in K; length 300 at
# position 150, in V), as the fleet's ``corrupt`` chaos leaves a block
NAN_ROWS = ((4, 16, "k"), (8, 150, "v"))


def check_paged_nan(torch, dev):
    """Kernel 1 turns a NaN K/V row of an f32 pool, a NaN scale of an
    int8 pool and NaN codes of an fp8 pool into a NaN output in every
    head of the rows that attend it, and leaves every other row
    bit-equal to its output without the NaN, with and without the fold:
    a kernel that hid the corrupted row would let the engine's
    finite-logits guard miss it.  Returns the rows hit per case."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    out = {}
    for pool_dtype in (torch.float32, torch.int8, torch.float8_e4m3fn):
        name = str(pool_dtype).split(".")[-1]
        for fold in (False, True):
            q, kp, vp, tb, ln, kn, vn, sc = split_inputs(torch, dev,
                                                         pool_dtype)
            extra = dict(k_new=kn, v_new=vn) if fold else {}
            clean = paged_decode_attention(q, kp, vp, tb, ln, **sc, **extra)
            nan = torch.tensor(float("nan"), device=dev)
            for b, pos, which in NAN_ROWS:
                blk = int(tb[b, pos // BS])
                if pool_dtype == torch.int8:
                    t = sc["k_scale" if which == "k" else "v_scale"]
                else:
                    t = kp if which == "k" else vp
                t[blk, pos % BS] = nan.to(t.dtype)
            got = paged_decode_attention(q, kp, vp, tb, ln, **sc, **extra)
            torch.cuda.synchronize()
            hit = [b for b, _, _ in NAN_ROWS]
            rest = [b for b in range(len(SPLIT_LENGTHS)) if b not in hit]
            key = f"{name},fold={fold}"
            if not all(torch.isnan(got[b]).all() for b in hit):
                raise AssertionError(f"nan {key}: a NaN K/V row (or scale) "
                                     "did not reach every head of the rows "
                                     "that attend it")
            if not torch.equal(got[rest], clean[rest]):
                raise AssertionError(f"nan {key}: rows that do not attend "
                                     "the NaN row changed")
            out[key] = {"nan_rows": hit, "rows_unchanged": len(rest)}
    return out


# kernel 1 as the chunked prefill calls it: the C = 64 queries of the
# 448-token prompt's last chunk are the batch, one table of T = 4 blocks
# broadcast over them (out of order in the pool), lengths 449..512, no fold
PCHUNK_C, PCHUNK_START = 64, 448
PCHUNK_TABLE = (5, 2, 9, 14)


def check_time_paged_chunk(torch, dev, card_name):
    """Kernel 1 at the chunk shape against its plain version (1e-4), then
    kernel, plain and library times (gather + scaled_dot_product_attention
    with the offset causal mask) beside the bound: each valid K/V row,
    q, the table and the lengths read once, the output written once,
    4*dh flops per q head per attended position."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    g = torch.Generator(device=dev).manual_seed(7)
    C = PCHUNK_C
    q = torch.randn((C, H, DH), generator=g, device=dev)
    kp = torch.randn((N, BS, G, DH), generator=g, device=dev)
    vp = torch.randn((N, BS, G, DH), generator=g, device=dev)
    table = torch.tensor(PCHUNK_TABLE, dtype=torch.int32, device=dev)
    tabs = table[None].expand(C, T).contiguous()
    lens = PCHUNK_START + 1 + torch.arange(C, dtype=torch.int32, device=dev)
    got = paged_decode_attention(q, kp, vp, tabs, lens)
    want = paged_decode_attention_ref(q, kp, vp, tabs, lens)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or not torch.allclose(
            got, want, rtol=TOL["float32"], atol=TOL["float32"]):
        raise AssertionError(f"chunk shape: kernel vs plain beyond 1e-4 "
                             f"(max abs {err})")
    for i in (0, C // 2, C - 1):
        alone = paged_decode_attention(q[i:i + 1], kp, vp, tabs[i:i + 1],
                                       lens[i:i + 1])
        if not torch.equal(alone[0], got[i]):
            raise AssertionError(f"chunk shape: query {i} alone differs "
                                 "from its row in the chunk")
    n_sets = sets_for(2 * kp.numel() * kp.element_size())
    pools = [(kp.clone(), vp.clone()) for _ in range(n_sets)]
    S = T * BS
    mask = (torch.arange(S, device=dev)[None, :]
            < lens[:, None])[None, None]                  # (1,1,C,S)
    qh = q.transpose(0, 1)[None]                          # (1,H,C,dh)

    def kernel(i):
        paged_decode_attention(q, pools[i][0], pools[i][1], tabs, lens)

    def plain(i):
        paged_decode_attention_ref(q, pools[i][0], pools[i][1], tabs, lens)

    def library(i):
        k = gather_kv_pages(pools[i][0], table[None]).transpose(1, 2)
        v = gather_kv_pages(pools[i][1], table[None]).transpose(1, 2)
        F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                       enable_gqa=True)

    t = timed(torch, {"ms": kernel, "plain_ms": plain,
                      "library_ms": library}, n_sets)
    rows = PCHUNK_START + C          # unique K/V rows the chunk reads
    nbytes = 4 * (2 * C * H * DH + 2 * rows * G * DH) + 4 * (C * T + C)
    attended = int(lens.sum())
    t["bound_ms"], t["bound_by"] = bound_for(nbytes, 4 * DH * H * attended,
                                             "float32", card_name)
    t["bytes_only_ms"] = nbytes / bandwidth_for(card_name) * 1e3
    t["max_abs_err"] = err
    t["shapes"] = {"C": C, "H": H, "G": G, "dh": DH, "bs": BS, "T": T,
                   "N": N, "lengths": [PCHUNK_START + 1, PCHUNK_START + C],
                   "dtype": "float32", "fold": False,
                   "grid": [16, G, C]}
    return t


# kernel 1 as speculative verify calls it: B = 4 slots x (K + 1 = 5)
# queries, each slot's table (out of order in the pool) repeated 5 times,
# lengths pos + 1 .. pos + 5, no fold
VERIFY_POS, VERIFY_K1 = (72, 295, 506, 0), 5


def verify_inputs(torch, dev, pool_dtype, seed=11):
    """(q, kp, vp, tables, lengths, scales, f32 pools) of the verify
    shape; an int8 / fp8 pool is quantized from the f32 one."""
    from repro_torch.serving.kv_cache import quantize_kv_rows
    g = torch.Generator(device=dev).manual_seed(seed)
    Q = len(VERIFY_POS) * VERIFY_K1
    q = torch.randn((Q, H, DH), generator=g, device=dev)
    kf = torch.randn((N, BS, G, DH), generator=g, device=dev)
    vf = torch.randn((N, BS, G, DH), generator=g, device=dev)
    perm = torch.randperm(N - 1, generator=g, device=dev) + 1
    slot_tables = torch.zeros((len(VERIFY_POS), T), dtype=torch.int32,
                              device=dev)
    for b, p in enumerate(VERIFY_POS):
        used = -(-(p + VERIFY_K1) // BS)
        slot_tables[b, :used] = perm[b * T:b * T + used]
    tables = slot_tables.repeat_interleave(VERIFY_K1, 0).contiguous()
    lens = (torch.tensor(VERIFY_POS, device=dev)[:, None] + 1
            + torch.arange(VERIFY_K1, device=dev)).reshape(-1).to(
                torch.int32)
    scales, kp, vp = {}, kf, vf
    if pool_dtype != torch.float32:
        kp, ks = quantize_kv_rows(kf, pool_dtype, torch.float16)
        vp, vs = quantize_kv_rows(vf, pool_dtype, torch.float16)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, kp, vp, tables, lens, scales


def check_time_paged_verify(torch, dev, card_name):
    """Kernel 1 at the verify shape, f32 / int8 / fp8 pools: against its
    plain version (1e-4), each query alone bit-identical to its row;
    then kernel, plain and library times (gather through each query's
    table, dequantized for int8 / fp8, + scaled_dot_product_attention
    with the per-query length mask) beside the bound: q, each slot's
    valid K/V rows (and scales) once, the tables and lengths read, the
    output written; 4*dh flops per q head per attended position."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    out = {}
    S = T * BS
    for name, pdt in (("float32", torch.float32), ("int8", torch.int8),
                      ("fp8", torch.float8_e4m3fn)):
        q, kp, vp, tb, ln, sc = verify_inputs(torch, dev, pdt)
        Q = q.shape[0]
        got = paged_decode_attention(q, kp, vp, tb, ln, **sc)
        want = paged_decode_attention_ref(q, kp, vp, tb, ln, **sc)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.isfinite(got).all() or not torch.allclose(
                got, want, rtol=TOL["float32"], atol=TOL["float32"]):
            raise AssertionError(f"verify shape, {name} pool: kernel vs "
                                 f"plain beyond 1e-4 (max abs {err})")
        for i in range(Q):
            alone = paged_decode_attention(q[i:i + 1], kp, vp, tb[i:i + 1],
                                           ln[i:i + 1], **sc)
            if not torch.equal(alone[0], got[i]):
                raise AssertionError(f"verify shape, {name} pool: query "
                                     f"{i} alone differs from its row")
        leaves = (kp, vp) + tuple(sc.values())
        n_sets = sets_for(sum(t.numel() * t.element_size() for t in leaves))
        pools = [tuple(t.clone() for t in leaves) for _ in range(n_sets)]
        mask = (torch.arange(S, device=dev)[None, :]
                < ln[:, None])[:, None, None, :]              # (Q,1,1,S)
        qh = q[:, :, None]                                    # (Q,H,1,dh)

        def call(fn, i, pools=pools, q=q, tb=tb, ln=ln, quant=bool(sc)):
            k, v, *rest = pools[i]
            extra = dict(k_scale=rest[0], v_scale=rest[1]) if quant else {}
            fn(q, k, v, tb, ln, **extra)

        def library(i, pools=pools, tb=tb, mask=mask, qh=qh):
            k, v, *rest = pools[i]
            kv = gather_kv_pages(k, tb), gather_kv_pages(v, tb)
            if rest:
                kv = tuple(x.float() * gather_kv_pages(s, tb).float()[
                    ..., None] for x, s in zip(kv, rest))
            F.scaled_dot_product_attention(
                qh, kv[0].transpose(1, 2), kv[1].transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        t = timed(torch, {
            "ms": lambda i: call(paged_decode_attention, i),
            "plain_ms": lambda i: call(paged_decode_attention_ref, i),
            "library_ms": library}, n_sets)
        row = G * DH * kp.element_size() + (2 * G if sc else 0)
        rows = sum(p + VERIFY_K1 for p in VERIFY_POS)
        nbytes = 4 * 2 * Q * H * DH + 2 * rows * row + 4 * (Q * T + Q)
        t["bound_ms"], t["bound_by"] = bound_for(
            nbytes, 4 * DH * H * int(ln.sum()), "float32", card_name)
        t["bytes_only_ms"] = nbytes / bandwidth_for(card_name) * 1e3
        t["max_abs_err"] = err
        out[name] = t
    out["shapes"] = {"slots": len(VERIFY_POS), "K": VERIFY_K1 - 1,
                     "Q": len(VERIFY_POS) * VERIFY_K1, "H": H, "G": G,
                     "dh": DH, "bs": BS, "T": T, "N": N,
                     "positions": list(VERIFY_POS), "q_dtype": "float32",
                     "fold": False, "grid": [16, G, len(VERIFY_POS)
                                             * VERIFY_K1]}
    return out


# dense decode attention (kernel 2) at the chain's dense shapes, and the
# chunked prefill's call (C queries over one request's cache broadcast
# over the batch, lengths start + i + 1)
DENSE_S = 512
DENSE_LENGTHS = (0, 78, 301, 512)
CHUNK_START = 300


def check_time_dense(torch, dev, card_name):
    """Kernel 2 against its plain version on the card, f32/bf16/f16,
    lengths with an empty row (the mean of its S V rows), each row alone
    bit-equal to its row in the batch, and the chunked prefill's stride-0
    cache at C = 64 queries; timed in f32 beside gather-free SDPA on the
    same cache."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (SPLIT,
                                                          decode_attention,
                                                          dense_plan)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    g = torch.Generator(device=dev).manual_seed(1)
    ln = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device=dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dt).split(".")[-1]
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((B, H, DH), (B, DENSE_S, G, DH),
                                 (B, DENSE_S, G, DH)))
        got = decode_attention(q, k, v, ln)
        want = decode_attention_ref(q, k, v, ln)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[name]
        if not torch.isfinite(got).all() or not torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"dense {name}: kernel vs plain beyond "
                                 f"rtol=atol={tol} (max abs {err})")
        mean = v[0].float().mean(0)                        # (G, DH)
        if not torch.allclose(got[0].float().reshape(G, H // G, DH),
                              mean[:, None].expand(-1, H // G, -1),
                              rtol=tol, atol=tol):
            raise AssertionError(f"dense {name}: length-0 row is not the "
                                 "mean of its V rows")
        for b in range(B):
            if not torch.equal(decode_attention(q[b:b + 1], k[b:b + 1],
                                                v[b:b + 1], ln[b:b + 1])[0],
                               got[b]):
                raise AssertionError(f"dense {name}: row {b} alone differs "
                                     "from its row in the batch")
        errs[name] = err
    # the chunked prefill's call: one cache read in place by C queries
    qc = torch.randn((CHUNK_C, H, DH), generator=g, device=dev)
    kc, vc = (torch.randn((1, DENSE_S, G, DH), generator=g, device=dev)
              .expand(CHUNK_C, -1, -1, -1) for _ in range(2))
    lc = torch.arange(CHUNK_START + 1, CHUNK_START + CHUNK_C + 1,
                      dtype=torch.int32, device=dev)
    got = decode_attention(qc, kc, vc, lc)
    err = (got - decode_attention_ref(qc, kc, vc, lc)).abs().max().item()
    if not torch.isfinite(got).all() or err > TOL["float32"]:
        raise AssertionError(f"dense stride-0 cache, C={CHUNK_C}: kernel vs "
                             f"plain max abs {err}")
    errs["float32,stride0,C=64"] = err
    q = torch.randn((B, H, DH), generator=g, device=dev)
    k = torch.randn((B, DENSE_S, G, DH), generator=g, device=dev)
    n_sets = sets_for(2 * k.numel() * 4)
    caches = [(k.clone(), k.clone() * 0.5) for _ in range(n_sets)]
    mask = (torch.arange(DENSE_S, device=dev)[None, :] <
            ln[:, None])[:, None, None, :]
    t = timed(torch, {
        "ms": lambda i: decode_attention(q, *caches[i], ln),
        "plain_ms": lambda i: decode_attention_ref(q, *caches[i], ln),
        "library_ms": lambda i: F.scaled_dot_product_attention(
            q[:, :, None], caches[i][0].transpose(1, 2),
            caches[i][1].transpose(1, 2), attn_mask=mask,
            enable_gqa=True)}, n_sets)
    # least work: q, the valid K rows, the valid V rows (all S for an
    # empty row, which averages them), the output, lengths
    k_rows = sum(DENSE_LENGTHS)
    v_rows = k_rows + DENSE_S * sum(n == 0 for n in DENSE_LENGTHS)
    nbytes = 4 * (2 * B * H * DH + (k_rows + v_rows) * G * DH + B)
    ops = 4 * DH * H * k_rows + v_rows * G * DH
    t["bound_ms"], t["bound_by"] = bound_for(nbytes, ops, "float32",
                                             card_name)
    L, stages = dense_plan(DENSE_S, DH, 4)
    t["plan"] = {"grid": [SPLIT, G, B], "cluster": [SPLIT, 1, 1],
                 "blocks": SPLIT * G * B, "tile_rows": L, "stages": stages}
    return errs, t


# the four gemvs of one full-width smollm-135m layer at B = 4 decode rows
GEMV_SHAPES = (("qkv", 576, 960), ("o", 576, 576), ("gate_up", 576, 3072),
               ("down", 1536, 576))


def check_time_gemv(torch, dev, card_name):
    """Kernel 3 against its plain version at the chain's four shapes, f32,
    bf16 and int8 weights, with and without bias; the B = 4 result must
    equal four B = 1 calls bit for bit.  Timed without bias, beside
    torch.matmul on the fp weight."""
    from repro_torch.kernels.gemv.ops import gemv, gemv_plan, quantize_weight
    from repro_torch.kernels.gemv.ref import gemv_ref
    g = torch.Generator(device=dev).manual_seed(2)
    errs, per_call = {}, []
    for shape_name, K, N in GEMV_SHAPES:
        for wname in ("float32", "bfloat16", "int8"):
            xdt = torch.bfloat16 if wname == "bfloat16" else torch.float32
            x = torch.randn((B, K), generator=g, device=dev).to(xdt)
            wf = torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)
            if wname == "int8":
                w, sc = quantize_weight(wf)
                wlib = wf
            else:
                w, sc = wf.to(xdt), None
                wlib = w
            tol = TOL["float32"] if wname == "float32" else 3e-2
            for bias in (False, True):
                b = torch.randn((N,), generator=g, device=dev).to(xdt) \
                    if bias else None
                got = gemv(x, w, b, w_scale=sc)
                want = gemv_ref(x, w, b, w_scale=sc)
                rows = torch.cat([gemv(x[i:i + 1], w, b, w_scale=sc)
                                  for i in range(B)])
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                key = f"{shape_name},{wname},bias={bias}"
                if not torch.isfinite(got).all() or not torch.allclose(
                        got.float(), want.float(), rtol=tol, atol=tol):
                    raise AssertionError(f"gemv {key}: kernel vs plain "
                                         f"beyond {tol} (max abs {err})")
                if not torch.equal(rows, got):
                    raise AssertionError(f"gemv {key}: B=4 differs from "
                                         "four B=1 calls")
                errs[key] = err
            n_sets = sets_for(w.numel() * w.element_size())
            ws = [w.clone() for _ in range(n_sets)]
            wls = [wlib.clone() for _ in range(n_sets)] \
                if wname == "int8" else ws
            t = timed(torch, {
                "ms": lambda i: gemv(x, ws[i], w_scale=sc),
                "plain_ms": lambda i: gemv_ref(x, ws[i], w_scale=sc),
                "library_ms": lambda i: torch.matmul(x.to(wls[i].dtype),
                                                     wls[i])}, n_sets)
            nbytes = (B * K * x.element_size() + K * N * w.element_size()
                      + B * N * x.element_size() + (4 * N if sc is not None
                                                    else 0))
            t["bound_ms"], t["bound_by"] = bound_for(
                nbytes, 2 * B * K * N, str(xdt).split(".")[-1], card_name)
            ksplit, n_tiles = gemv_plan(K, N)
            t.update(shape=shape_name, K=K, N=N, B=B, w_dtype=wname,
                     ksplit=ksplit, blocks=ksplit * n_tiles)
            per_call.append(t)
            del ws, wls
    return errs, per_call


def serve(torch, dev, model, params, prompts, engine_kw=None, warm=None,
          **kw):
    """Serve ``prompts`` x 32 new tokens on 4 slots with the config knobs
    ``kw`` (``engine_kw``: the engine's other arguments, e.g. a drafter;
    ``warm``: one prompt served alone first, x 4 new tokens, so its
    blocks are in the prefix index before the others are admitted);
    returns (streams, engine, kernel 1 launches in the run)."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    eng = LPUEngine(model, params, EngineConfig(slots=4, max_seq=512, **kw),
                    device=dev, **(engine_kw or {}))
    paged_decode_attention.launches = 0
    if warm is not None:
        eng.generate([warm], max_new_tokens=4)
    outs = eng.generate(prompts, max_new_tokens=32)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    on_graphs(eng)
    return outs, eng, paged_decode_attention.launches


ADMISSION_KINDS = ("prefill", "chunk", "sample", "cow")


def admission_replays(eng):
    """{kind: replays} of the engine's admission programs."""
    return {k: eng._admit.replays_of(k) for k in ADMISSION_KINDS}


def on_graphs(eng):
    """Raise unless an engine with graphs on ran its decode windows and
    verify rounds (host sampling: its decode steps) as replays of
    captured graphs, and (an attention-only
    stack, whose prompts are bucketed) each kind of admission step it
    ran — monolithic prefills, chunks and prefix tails, the first-token
    sampler, copy-on-write block copies — as well."""
    if not eng.graphs:
        return
    st = eng.stats
    if eng.sampling == "host":
        # a host-sampled decode step is an admission-side program; the
        # host-sampled verify round stays eager
        if st.device_decode_steps and not eng._admit.replays_of(
                "host_decode"):
            raise AssertionError(f"the engine replayed no host-sampled "
                                 f"decode step: {st}")
    elif (st.device_decode_steps or st.spec_rounds) and \
            not eng._programs.replays:
        raise AssertionError(f"the engine replayed no captured window: "
                             f"{st}")
    ran = {"sample": eng.sampling == "fused" and st.prefill_syncs > 0}
    if eng.bucketed:
        ran.update(
            chunk=st.prefill_chunks > 0 or st.prefix_hits > 0,
            prefill=not eng.prefill_chunk and st.prefills > st.prefix_hits,
            cow=st.cow_blocks > 0)
    missing = [k for k, r in ran.items() if r and not
               eng._admit.replays_of(k)]
    if missing:
        raise AssertionError(f"the engine ran {missing} without replaying "
                             f"their programs: {admission_replays(eng)}, "
                             f"{st}")


def device_kernels(fn):
    """Run ``fn()`` under torch.profiler recording the card's activity
    only (recording the host's ops as well cost ~80 s more over one
    engine run, most of it in ``key_averages``) and return the kernels'
    averages by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def profile_engine(torch, dev, model, params, prompts, wall_s,
                   engine_kw=None, **kw):
    """Device time by kernel over the same run (streamed, with the
    engine knobs ``kw`` and the engine's other arguments ``engine_kw``)
    under torch.profiler; the busy share divides it by that run's
    unprofiled wall time, the per-token times by its tokens.  The
    profiler's count of kernel 1 beside the launch registry's for the
    run plus the warm-ups before its captures (which the registry does
    not count): equal when the profiler sees the kernels inside a graph
    replay.  None where the profiler saw no device activity."""
    ran = {}

    def run():
        _, ran["eng"], ran["launches"] = serve(
            torch, dev, model, params, prompts, engine_kw=engine_kw,
            paged_kernel="stream", **kw)
    kernels = device_kernels(run)
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    paged = [e for e in kernels if "paged_decode_kernel" in e.key]
    eng = ran["eng"]
    tokens = eng.stats.tokens
    warm = sum(p.warm_launches.get("paged_decode_attention", 0)
               for p in (eng._programs, eng._admit))
    return {"device_busy_ms": busy_us / 1e3,
            "unprofiled_wall_ms": wall_s * 1e3,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "tokens": tokens,
            "device_ms_per_token": busy_us / 1e3 / tokens,
            "wall_ms_per_token": wall_s * 1e3 / tokens,
            "paged_kernel_ms": sum(e.self_device_time_total
                                   for e in paged) / 1e3,
            "kernel1_profiler_count": sum(e.count for e in paged),
            "kernel1_registry_launches": ran["launches"],
            "kernel1_warm_up_launches": warm,
            "graph_replays": eng.stats.graph_replays,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def smollm(torch, dev):
    """Full-width smollm-135m (f32, random weights from seed 0) and the
    engine phases' 8 seeded prompts of 2-64 tokens."""
    import numpy as np
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build_model
    cfg = get_config("smollm-135m")
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, dev)
    params = init_params(cfg, plan, seed=0, device=dev)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                            size=rng.randint(2, 65))]
               for _ in range(8)]
    return model, params, prompts


def run_engine(torch, dev, model, params, prompts):
    cfg = model.cfg
    serve(torch, dev, model, params, prompts[:2], paged_kernel="stream")
    stream, eng, launches = serve(torch, dev, model, params, prompts,
                                  paged_kernel="stream")
    st = eng.stats
    if st.device_decode_steps == 0 or \
            launches != cfg.n_layers * st.device_decode_steps:
        raise AssertionError(
            f"kernel launches {launches} != n_layers {cfg.n_layers} x "
            f"decode steps {st.device_decode_steps}")
    for o in stream:
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"bad stream {o}")
    if st.graph_captures == 0 or st.graph_replays == 0:
        raise AssertionError(f"the engine ran no captured window: {st}")
    profile = profile_engine(torch, dev, model, params, prompts, st.wall)
    # the eager twin: the same windows launched op by op from Python
    eager, eeng, elaunch = serve(torch, dev, model, params, prompts,
                                 engine_kw=dict(graphs=False),
                                 paged_kernel="stream")
    if eager != stream:
        raise AssertionError("graph and eager-twin greedy streams differ")
    if elaunch != launches or \
            eeng.stats.device_decode_steps != st.device_decode_steps:
        raise AssertionError(f"eager twin: {elaunch} launches over "
                             f"{eeng.stats.device_decode_steps} decode "
                             f"steps against {launches} over "
                             f"{st.device_decode_steps}")
    eager_profile = profile_engine(torch, dev, model, params, prompts,
                                   eeng.stats.wall,
                                   engine_kw=dict(graphs=False))
    gather, geng, glaunch = serve(torch, dev, model, params, prompts,
                                  paged_kernel="gather")
    if gather != stream:
        raise AssertionError("stream and gather greedy streams differ")
    if glaunch != 0:
        raise AssertionError("the gather oracle launched the kernel")
    pre, peng, plaunch = serve(torch, dev, model, params, prompts,
                               paged_kernel="stream", block_size=32,
                               num_blocks=7, steps_per_sync=4)
    if peng.stats.preemptions == 0:
        raise AssertionError("the small pool did not force a preemption")
    if pre != stream:
        raise AssertionError("streams under preemption and 4-step "
                             "windows differ")
    if plaunch != cfg.n_layers * peng.stats.device_decode_steps:
        raise AssertionError("launch count under preemption")
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": "float32", "slots": 4,
            "max_seq": 512, "requests": len(prompts), "max_new": 32,
            "tokens": st.tokens, "tokens_per_s": st.tokens_per_s,
            "wall_s": st.wall, "decode_steps": st.steps,
            "device_decode_steps": st.device_decode_steps,
            "kernel_launches": launches,
            "gather_tokens_per_s": geng.stats.tokens_per_s,
            "preempt_run": {"block_size": 32, "num_blocks": 7,
                            "steps_per_sync": 4,
                            "preemptions": peng.stats.preemptions,
                            "device_decode_steps":
                                peng.stats.device_decode_steps,
                            "kernel_launches": plaunch},
            "streams_equal_gather": True,
            "streams": stream,
            "streams_equal_preempt": True,
            "graph_captures": st.graph_captures,
            "graph_replays": st.graph_replays,
            "profile": profile,
            "eager_twin": {"tokens_per_s": eeng.stats.tokens_per_s,
                           "wall_s": eeng.stats.wall,
                           "kernel_launches": elaunch,
                           "streams_equal_graphs": True,
                           "profile": eager_profile},
            "prefill_paths": run_prefill_paths(torch, dev, model, params,
                                               prompts, stream)}


# the prefill paths of the engine (chunked prefill, prefix cache,
# copy-on-write): chunks of 64, a 448-token prompt, a 256-token system
# prompt (two full blocks of 128)
PREFILL_CHUNK = 64
LONG_PROMPT = 448
SYS_PROMPT = 256


def agree(torch, model, params, prompts, a, b, what, gaps_fn=None,
          tol=None):
    """Greedy streams ``a`` and ``b`` equal, or first apart where the
    model's own logits (a plain forward over the prompt and the shared
    tokens) have a top-2 gap of at most CHAIN_TOL: a near tie, where
    another order of f32 sums may pick either token.  On an int8/fp8
    pool (``gaps_fn(prompt, stream)`` gives the gaps of the quantized
    path) the bound is CHAIN_TOL_QUANT: there a last-bit difference in a
    K/V row can round its stored code one step apart, and the chain
    holds its quantized variants' logits to that bound.  ``tol`` sets
    the bound (a bf16 model's gaps are its bf16 logits').  Raises
    otherwise.
    Returns how many streams were equal, each divergence with its gap,
    and the smallest top-2 gap over the tokens both streams share (the
    margin the prefill paths' rounding noise has to cross)."""
    out, margin = [], float("inf")
    for i, (p, x, y) in enumerate(zip(prompts, a, b)):
        if gaps_fn is not None:
            gaps = gaps_fn(p, x)                    # row j picks x[j]
        else:
            toks = torch.tensor([list(p) + list(x[:-1])],
                                device=model.device)
            logits, _ = model.forward(params, toks, mode="train")
            gaps = top2_gap(logits[0, len(p) - 1:])
        at = next((j for j, (u, v) in enumerate(zip(x, y)) if u != v),
                  None)
        if at is None and len(x) != len(y):
            raise AssertionError(f"{what}: stream {i} lengths differ")
        if at is not None:
            gap = gaps[at].item()
            bound = tol if tol is not None else \
                CHAIN_TOL if gaps_fn is None else CHAIN_TOL_QUANT
            if gap > bound:
                raise AssertionError(
                    f"{what}: stream {i} differs at token {at} where the "
                    f"top-2 gap is {gap} > {bound}")
            out.append({"request": i, "at": at, "top2_gap": gap})
            gaps = gaps[:at]
        if len(gaps):
            margin = min(margin, gaps.min().item())
    return {"equal": len(prompts) - len(out), "diverged_at_near_ties": out,
            "min_top2_gap": margin}


def chunk_vs_monolithic_row(torch, dev, model, params, prompt):
    """The last prompt row's logits by the engine's two prefill paths:
    the monolithic bucketed prefill (plain flash attention, norms and
    products over the whole bucket) and 64-token chunks against a fresh
    pool through kernel 1.  Their difference is the noise a chunk adds."""
    n = len(prompt)
    bucket = 512
    buf = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    buf[0, :n] = torch.tensor(prompt, device=dev)
    logits, _ = model.forward(params, buf, mode="prefill",
                              cache=model.init_cache(1, bucket),
                              positions=torch.arange(bucket,
                                                     device=dev)[None])
    mono = logits[0, n - 1]
    pool = model.init_cache(1, bucket, paged=True, num_blocks=5,
                            block_size=128)
    table = torch.arange(1, 5, dtype=torch.int32, device=dev)[None]
    for start in range(0, n, PREFILL_CHUNK):
        nv = min(PREFILL_CHUNK, n - start)
        tok = torch.zeros((1, PREFILL_CHUNK), dtype=torch.long, device=dev)
        tok[0, :nv] = buf[0, start:start + nv]
        logits, _ = model.forward(
            params, tok, mode="chunk_prefill",
            positions=start + torch.arange(PREFILL_CHUNK, dtype=torch.int32,
                                           device=dev)[None],
            cache=pool, block_tables=table, paged_kernel="stream",
            kv_valid_len=torch.tensor(start + nv, dtype=torch.int32,
                                      device=dev))
    chunk = logits[0, nv - 1]
    torch.cuda.synchronize()
    return {"prompt_len": n, "chunk": PREFILL_CHUNK,
            "max_abs_diff_logits": (chunk - mono).abs().max().item(),
            "top2_gap_monolithic": top2_gap(mono).item(),
            "argmax_equal": bool(chunk.argmax() == mono.argmax())}


def run_prefill_paths(torch, dev, model, params, prompts, stream):
    """Runs (a)-(e) of the engine's prefill paths at full width, each
    held against its monolithic / prefix-off twin by :func:`agree`, with
    kernel 1's exact launch count: 30 per device decode step, per prefill
    chunk and per prefix tail."""
    import numpy as np
    t0 = time.perf_counter()
    L = model.cfg.n_layers
    V = model.cfg.vocab_size
    rng = np.random.RandomState(18)
    long9 = prompts + [[int(t) for t in rng.randint(1, V,
                                                    size=LONG_PROMPT)]]
    sysp = [int(t) for t in rng.randint(1, V, size=SYS_PROMPT)]
    shared = [sysp + [int(t) for t in rng.randint(1, V, size=n)]
              for n in (5, 17, 29, 40)]

    def rec(eng, launches, **extra):
        s = eng.stats
        out = {"tokens": s.tokens, "tokens_per_s": s.tokens_per_s,
               "wall_s": s.wall, "decode_steps": s.steps,
               "device_decode_steps": s.device_decode_steps,
               "prefills": s.prefills, "prefill_chunks": s.prefill_chunks,
               "decode_stalls": s.decode_stalls,
               "preemptions": s.preemptions, "kernel_launches": launches,
               "graphs": eng.graphs, "graph_captures": s.graph_captures,
               "graph_replays": s.graph_replays,
               "admission_replays": admission_replays(eng)}
        if eng.prefix is not None:
            out.update(prefix_hits=s.prefix_hits,
                       prefix_hit_blocks=s.prefix_hit_blocks,
                       prefill_tokens_saved=s.prefill_tokens_saved,
                       cow_blocks=s.cow_blocks,
                       evicted_blocks=s.evicted_blocks)
        out.update(extra)
        return out

    def want(eng, tails=0):
        s = eng.stats
        return L * (s.device_decode_steps + s.prefill_chunks + tails)

    out = {"chunk_row_vs_monolithic": chunk_vs_monolithic_row(
        torch, dev, model, params, long9[-1])}
    # (a) chunked against monolithic on the 9 prompts
    mono, meng, ml = serve(torch, dev, model, params, long9,
                           paged_kernel="stream")
    chunked, ceng, cl = serve(torch, dev, model, params, long9,
                              paged_kernel="stream",
                              prefill_chunk=PREFILL_CHUNK)
    if ceng.stats.decode_stalls != 0 or ceng.stats.prefill_chunks < 7:
        raise AssertionError(f"(a) chunked: {ceng.stats}")
    if cl != want(ceng):
        raise AssertionError(f"(a) kernel launches {cl} != {want(ceng)}")
    if ml != want(meng):
        raise AssertionError(f"(a) monolithic launches {ml}")
    ceng.check_pool_balanced()
    out["monolithic"] = rec(meng, ml)
    out["chunked"] = rec(ceng, cl, vs_monolithic=agree(
        torch, model, params, long9, chunked, mono, "(a) chunked"))
    out["chunked_streams"] = chunked
    out["chunked"]["profile"] = profile_engine(
        torch, dev, model, params, long9, ceng.stats.wall,
        prefill_chunk=PREFILL_CHUNK)
    # (a) their eager twins: every prefill, chunk and window launched op
    # by op from Python
    t_e = time.perf_counter()
    for name, streams, kw in (("monolithic", mono, {}),
                              ("chunked", chunked,
                               dict(prefill_chunk=PREFILL_CHUNK))):
        e_out, e_eng, e_l = serve(torch, dev, model, params, long9,
                                  engine_kw=dict(graphs=False),
                                  paged_kernel="stream", **kw)
        if e_l != want(e_eng):
            raise AssertionError(f"(a) {name} eager twin: kernel launches "
                                 f"{e_l} != {want(e_eng)}")
        e_eng.check_pool_balanced()
        out[name]["eager_twin"] = rec(e_eng, e_l, vs_graphs=agree(
            torch, model, params, long9, e_out, streams,
            f"(a) {name} eager twin"))
    out["eager_twins_s"] = time.perf_counter() - t_e
    # (b) the same on the gather oracle
    gathered, geng, gl = serve(torch, dev, model, params, long9,
                               paged_kernel="gather",
                               prefill_chunk=PREFILL_CHUNK)
    if gl != 0:
        raise AssertionError("(b) the gather oracle launched the kernel")
    out["chunked_gather"] = rec(geng, gl, vs_monolithic=agree(
        torch, model, params, long9, gathered, mono, "(b) chunked gather"))
    # (c) a shared system prompt, prefix on against off
    off, oeng, ol = serve(torch, dev, model, params, shared,
                          paged_kernel="stream")
    on, peng, pl = serve(torch, dev, model, params, shared,
                         paged_kernel="stream", prefix_cache=True)
    ps = peng.stats
    if ps.prefix_hits < 3 or ps.prefill_tokens_saved < 3 * SYS_PROMPT:
        raise AssertionError(f"(c) prefix: {ps}")
    if pl != want(peng, ps.prefix_hits):
        raise AssertionError(f"(c) kernel launches {pl} != "
                             f"{want(peng, ps.prefix_hits)}")
    peng.check_pool_balanced()
    out["prefix_off"] = rec(oeng, ol)
    out["prefix_on"] = rec(peng, pl, vs_off=agree(
        torch, model, params, shared, on, off, "(c) prefix on"))
    # (d) two identical prompts at once: the tail's write copies on write
    twin = [list(sysp), list(sysp)]
    t_off, _, _ = serve(torch, dev, model, params, twin,
                        paged_kernel="stream")
    t_on, teng, tl = serve(torch, dev, model, params, twin,
                           paged_kernel="stream", prefix_cache=True)
    if teng.stats.cow_blocks < 1:
        raise AssertionError("(d) no copy-on-write")
    if tl != want(teng, teng.stats.prefix_hits):
        raise AssertionError(f"(d) kernel launches {tl}")
    teng.check_pool_balanced()
    out["cow"] = rec(teng, tl, vs_off=agree(
        torch, model, params, twin, t_on, t_off, "(d) copy-on-write"),
        twins=agree(torch, model, params, twin, t_on, t_on[::-1],
                    "(d) the twins"))
    # (e) chunked with a pool small enough to preempt
    pre, reng, rl = serve(torch, dev, model, params, prompts,
                          paged_kernel="stream", prefill_chunk=PREFILL_CHUNK,
                          block_size=32, num_blocks=7, steps_per_sync=4)
    if reng.stats.preemptions == 0:
        raise AssertionError("(e) the small pool did not force a "
                             "preemption")
    if rl != want(reng):
        raise AssertionError(f"(e) kernel launches {rl} != {want(reng)}")
    reng.check_pool_balanced()
    out["chunked_preempt"] = rec(
        reng, rl, block_size=32, num_blocks=7, steps_per_sync=4,
        vs_monolithic=agree(torch, model, params, prompts, pre, stream,
                            "(e) chunked under preemption"))
    out["kernel_launches"] = cl + pl + tl + rl
    out["long_prompt"] = long9[-1]
    out["phase_s"] = time.perf_counter() - t0
    return out


# time to first token: requests of one new token each on a warmed, idle
# engine
TTFT_REQUESTS = 5


def time_to_first_token(torch, eng, prompt):
    """Time to first token of ``prompt`` on a warmed, idle engine (its
    programs captured): the host clock from ``submit`` to the first
    token's ``stream_cb``, over TTFT_REQUESTS requests of one new token
    (median and all), then torch.profiler's device time over one more:
    one prefill (all its chunks, on a chunked engine) and the first
    token's sampling.  A graph engine must capture nothing while
    measured and replay every step."""
    import statistics
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    caps, reps = eng._admit.captures, eng._admit.replays
    ms, first = [], set()
    for _ in range(TTFT_REQUESTS):
        hit = []
        t0 = time.perf_counter()
        eng.submit(prompt, 1, stream_cb=lambda rid, tok: hit.append(
            (time.perf_counter(), tok)))
        while not hit:
            eng.step()
        ms.append((hit[0][0] - t0) * 1e3)
        first.add(hit[0][1])
        eng.drain()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        first.add(eng.generate([prompt], 1)[0][0])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    what = f"ttft {eng.cfg.name} graphs={eng.graphs}"
    if len(first) != 1 or not busy_us:
        raise AssertionError(f"{what}: first tokens {first}, device time "
                             f"{busy_us} us")
    if eng.graphs and (eng._admit.captures != caps
                       or eng._admit.replays == reps):
        raise AssertionError(f"{what}: {eng._admit.captures - caps} "
                             "captures while measured, replays "
                             f"{eng._admit.replays - reps}")
    return {"ttft_ms": statistics.median(ms), "ttft_ms_all": ms,
            "prefill_device_ms": busy_us / 1e3,
            "device_kernels": sum(e.count for e in kernels),
            "prompt_len": len(prompt),
            "bucket": eng.sched.bucket(len(prompt)),
            "prefill_chunk": eng.prefill_chunk, "graphs": eng.graphs,
            "admission_replays": eng._admit.replays - reps,
            "first_token": first.pop(), "requests": TTFT_REQUESTS}


def run_ttft_smollm(torch, dev, model, params, prompt):
    """Time to first token of full-width smollm-135m (f32, 4 slots,
    max_seq 512) on ``prompt`` (the 448-token one): monolithic (bucket
    512) and in chunks of 64, each on captured programs and on the eager
    twin, each engine warmed by one request of the same prompt; the
    twins' first tokens equal (or apart at a near tie)."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    out = {}
    for name, kw in (("monolithic", {}),
                     ("chunked", dict(prefill_chunk=PREFILL_CHUNK))):
        for graphs in (True, False):
            eng = LPUEngine(model, params, EngineConfig(
                slots=4, max_seq=512, **kw), device=dev, graphs=graphs)
            eng.generate([prompt], 1)                       # warm
            on_graphs(eng)
            out[name + ("" if graphs else "_eager")] = \
                time_to_first_token(torch, eng, prompt)
            del eng
        g, e = out[name], out[name + "_eager"]
        g["vs_eager"] = agree(torch, model, params, [prompt],
                              [[g["first_token"]]], [[e["first_token"]]],
                              f"ttft {name}")
    return out


# ---------------------------------------------------------------------------
# (f) the int8/fp8 pool and (g) speculation, through the engine
# ---------------------------------------------------------------------------

def quant_gaps(torch, model, params, tokens, qdtype):
    """Top-2 gaps along ``tokens`` by the quantized path: the tokens
    prefilled in chunks of 64 into a fresh int8/fp8 pool (each chunk
    attends the stored rows, as decode and verify do); row j scores
    token j + 1."""
    dev = model.device
    n = len(tokens)
    pool = model.init_cache(1, 512, paged=True, num_blocks=T + 1,
                            block_size=BS, dtype=qdtype,
                            scale_dtype=torch.float16)
    table = torch.arange(1, T + 1, dtype=torch.int32, device=dev)[None]
    buf = torch.tensor(tokens, dtype=torch.long, device=dev)
    rows = []
    for start in range(0, n, PREFILL_CHUNK):
        nv = min(PREFILL_CHUNK, n - start)
        tok = torch.zeros((1, PREFILL_CHUNK), dtype=torch.long, device=dev)
        tok[0, :nv] = buf[start:start + nv]
        logits, _ = model.forward(
            params, tok, mode="chunk_prefill",
            positions=start + torch.arange(PREFILL_CHUNK, dtype=torch.int32,
                                           device=dev)[None],
            cache=pool, block_tables=table, paged_kernel="gather",
            kv_valid_len=torch.tensor(start + nv, dtype=torch.int32,
                                      device=dev))
        rows.append(logits[0, :nv])
    return top2_gap(torch.cat(rows))


def pool_checks(eng, what):
    """The pool balanced after the drain, and its reported bytes those
    of its leaves: per-rank block bytes x blocks on each rank, tp times
    that over the ring."""
    from repro_torch.serving.kv_cache import cache_bytes, per_rank_block_bytes
    eng.check_pool_balanced()
    a = eng.plan.attn
    want = per_rank_block_bytes(eng.cfg.n_layers, a.kv_per_rank, a.d_head,
                                eng.block_size, eng.kv_prec.itemsize,
                                eng.kv_prec.scale_itemsize) * eng.num_blocks
    if eng.per_rank_kv_bytes() != want or cache_bytes(eng.cache) != want \
            or eng.kv_cache_bytes() != want * eng.tp:
        raise AssertionError(f"{what}: kv_cache_bytes "
                             f"{eng.kv_cache_bytes()} != {want} x {eng.tp}")


def run_rec(eng, launches, **extra):
    """One run's record: its counters, tokens/s and kernel 1 launches."""
    s = eng.stats
    out = {"tokens": s.tokens, "tokens_per_s": s.tokens_per_s,
           "wall_s": s.wall, "decode_steps": s.steps,
           "device_decode_steps": s.device_decode_steps,
           "spec_rounds": s.spec_rounds, "prefill_chunks": s.prefill_chunks,
           "prefills": s.prefills, "preemptions": s.preemptions,
           "graph_captures": s.graph_captures,
           "graph_replays": s.graph_replays,
           "admission_replays": admission_replays(eng),
           "kernel_launches": launches}
    if eng.prefix is not None:
        out.update(prefix_hits=s.prefix_hits, cow_blocks=s.cow_blocks,
                   prefill_tokens_saved=s.prefill_tokens_saved)
    if eng.drafter is not None:
        out.update(draft_tokens=s.draft_tokens,
                   accepted_tokens=s.accepted_tokens,
                   acceptance_rate=s.acceptance_rate,
                   accepted_per_window=s.accepted_per_window)
    out.update(extra)
    return out


def launches_want(eng):
    """Kernel 1's exact launches in a streamed run: once per layer per
    device decode step, verify round, prefill chunk and prefix tail (a
    prefix hit's tail is one more chunk when the engine prefills in
    chunks, and counted with them)."""
    s = eng.stats
    tails = s.prefix_hits if eng.prefix is not None and \
        not eng.prefill_chunk else 0
    return eng.cfg.n_layers * (s.device_decode_steps + s.spec_rounds
                               + s.prefill_chunks + tails)


def run_quantized_engine(torch, dev, model, params, prompts, f32_streams):
    """(f): full-width smollm-135m on an int8 and an fp8 pool.  Every run
    prefills in chunks of 64 (a monolithic prefill attends the prompt's
    f32 rows, chunks and decode the stored rows, so twins that prefill
    differently part by the quantization noise; ROADMAP §3): the 8
    prompts and the 448-token one through kernel 1 and through the
    gather oracle of the same pool, the shared 256-token system prompt
    (served after it alone, so its blocks are indexed) with the prefix
    cache on and off, and a pool of 7 blocks of 32 that
    preempts against the uncontended run; streams equal or apart only
    at a near tie of the quantized path, exact launches, the pool
    balanced and its bytes its leaves'.  Reported without a gate: the
    common prefix with the f32 pool's streams and the bytes moved per
    step against an f16 pool."""
    import numpy as np
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    t0 = time.perf_counter()
    V = model.cfg.vocab_size
    rng = np.random.RandomState(18)
    long9 = prompts + [[int(t) for t in rng.randint(1, V,
                                                    size=LONG_PROMPT)]]
    sysp = [int(t) for t in rng.randint(1, V, size=SYS_PROMPT)]
    shared = [sysp + [int(t) for t in rng.randint(1, V, size=n)]
              for n in (5, 17, 29, 40)]
    f16 = LPUEngine(model, params, EngineConfig(
        slots=4, max_seq=512, kv_dtype="float16"), device=dev)
    out, launches = {}, 0
    for qname, qdt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        def gaps(p, x, qdt=qdt):
            return quant_gaps(torch, model, params, list(p) + list(x[:-1]),
                              qdt)[len(p) - 1:]

        def run(ps, **kw):
            o, e, n = serve(torch, dev, model, params, ps, kv_dtype=qname,
                            prefill_chunk=PREFILL_CHUNK, **kw)
            if kw.get("paged_kernel") != "gather" and \
                    n != launches_want(e):
                raise AssertionError(f"(f) {qname}: kernel launches {n} "
                                     f"!= {launches_want(e)}")
            pool_checks(e, f"(f) {qname} {kw}")
            return o, e, n

        rec = {}
        st, seng, sl = run(long9, paged_kernel="stream")
        ga, geng, gl = run(long9, paged_kernel="gather")
        if gl != 0:
            raise AssertionError("(f) the gather oracle launched kernel 1")
        rec["stream"] = run_rec(seng, sl)
        rec["gather"] = run_rec(geng, gl, vs_stream=agree(
            torch, model, params, long9, ga, st, f"(f) {qname} gather",
            gaps_fn=gaps))
        off, oeng, ol = run(shared, paged_kernel="stream", warm=sysp)
        on, peng, pl = run(shared, paged_kernel="stream", prefix_cache=True,
                           warm=sysp)
        if peng.stats.prefix_hits < 3:
            raise AssertionError(f"(f) {qname} prefix: {peng.stats}")
        rec["prefix_off"] = run_rec(oeng, ol)
        rec["prefix_on"] = run_rec(peng, pl, vs_off=agree(
            torch, model, params, shared, on, off, f"(f) {qname} prefix",
            gaps_fn=gaps))
        pre, reng, rl = run(prompts, paged_kernel="stream", block_size=32,
                            num_blocks=7, steps_per_sync=4)
        if reng.stats.preemptions == 0:
            raise AssertionError(f"(f) {qname}: the small pool did not "
                                 "preempt")
        rec["preempt"] = run_rec(reng, rl, block_size=32, num_blocks=7,
                                 steps_per_sync=4, vs_uncontended=agree(
                                     torch, model, params, prompts, pre,
                                     st[:len(prompts)],
                                     f"(f) {qname} preempted",
                                     gaps_fn=gaps))
        common = []
        for a, b in zip(st, f32_streams):
            k = next((i for i, (u, v) in enumerate(zip(a, b)) if u != v),
                     min(len(a), len(b)))
            common.append(k / min(len(a), len(b)))
        rec["common_prefix_vs_f32"] = {
            "mean": sum(common) / len(common), "per_stream": common,
            "reference_gate": 0.75}
        rec["kv_bytes_moved_per_step"] = seng.kv_bytes_moved_per_step()
        rec["moved_vs_f16"] = (seng.kv_bytes_moved_per_step()
                               / f16.kv_bytes_moved_per_step())
        dh = seng.plan.attn.d_head
        rec["moved_vs_f16_expected"] = (dh + 2) / (2 * dh)
        rec["kv_cache_bytes"] = seng.kv_cache_bytes()
        launches += sl + ol + pl + rl
        rec["kernel_launches"] = sl + ol + pl + rl
        out[qname] = rec
    out["kernel_launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    return out


class OracleDrafter:
    """Proposes the plain run's own continuation: every draft accepted.
    With ``shift`` it proposes that continuation's tokens plus one
    (mod the vocabulary), so the first draft of every window differs
    from the plain run's greedy token: every draft rejected."""

    def __init__(self, prompts, outs, vocab, shift=0):
        self.ref = {tuple(p): o for p, o in zip(prompts, outs)}
        self.vocab, self.shift = vocab, shift

    def propose(self, tokens, k):
        for p, out in self.ref.items():
            if len(p) <= len(tokens) and tuple(tokens[:len(p)]) == p:
                done = len(tokens) - len(p)
                return [(t + self.shift) % self.vocab
                        for t in out[done:done + k]]
        return []


SPEC_K = 4


def run_speculative_engine(torch, dev, model, params, prompts):
    """(g): full-width smollm-135m with draft_k = 4 on the f32 pool: the
    n-gram drafter on prompts that repeat a motif, an oracle drafter
    (the plain run's continuation: all accepted), an adversarial one
    (that continuation shifted by one token: all rejected), the model
    drafter (a reduced smollm-135m over the target's vocabulary, seed 1),
    the n-gram drafter on the
    int8 pool, and with chunks of 64 and the prefix cache (4 prompts
    sharing a 256-token system prompt and the bare system prompt, served
    after it alone); each against
    the plain run with the same knobs: streams equal or apart only at a
    near tie, the pool balanced after every rollback, kernel 1 launched
    exactly once per layer per device decode step, verify round, chunk
    and prefix tail."""
    import numpy as np
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    V = model.cfg.vocab_size
    rng = np.random.RandomState(19)
    motif = []
    for n_m, reps, tail in ((8, 6, 3), (12, 4, 5), (16, 3, 0), (5, 9, 2),
                            (10, 5, 7), (24, 2, 4), (6, 8, 1), (9, 5, 6)):
        m = [int(t) for t in rng.randint(1, V, size=n_m)]
        motif.append(m * reps + m[:tail])
    sysp = [int(t) for t in rng.randint(1, V, size=SYS_PROMPT)]
    shared = [sysp + [int(t) for t in rng.randint(1, V, size=n)]
              for n in (5, 17, 29, 40)] + [list(sysp)]
    # the drafter shares the target's vocabulary, as a deployed one does
    dcfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                               vocab_size=V)
    dplan = plan_model(dcfg, None, (1,), "serve", esl_overlap=False,
                       remat="none", compute_dtype="float32",
                       param_dtype="float32")
    dmodel = build_model(dcfg, dplan, dev)
    dparams = dmodel.init(seed=1)
    out, launches, plain = {}, 0, {}

    def run(name, ps, engine_kw=None, twin=None, **kw):
        nonlocal launches
        o, e, n = serve(torch, dev, model, params, ps, engine_kw=engine_kw,
                        **kw)
        if n != launches_want(e):
            raise AssertionError(f"(g) {name}: kernel launches {n} != "
                                 f"{launches_want(e)}")
        pool_checks(e, f"(g) {name}")
        extra = {}
        if twin is not None:
            qdt = {"int8": torch.int8}.get(kw.get("kv_dtype"))
            gaps = None if qdt is None else (
                lambda p, x: quant_gaps(torch, model, params,
                                        list(p) + list(x[:-1]),
                                        qdt)[len(p) - 1:])
            extra["vs_plain"] = agree(torch, model, params, ps, o, twin,
                                      f"(g) {name}", gaps_fn=gaps)
        launches += n
        out[name] = run_rec(e, n, **extra)
        return o, e

    spec = dict(speculate="ngram", draft_k=SPEC_K)
    plain["motif"], _ = run("plain", motif)
    run("ngram", motif, twin=plain["motif"], **spec)
    _, oe = run("oracle", motif, twin=plain["motif"], draft_k=SPEC_K,
                engine_kw=dict(drafter=OracleDrafter(motif, plain["motif"],
                                                     V)))
    _, ae = run("adversarial", motif, twin=plain["motif"], draft_k=SPEC_K,
                engine_kw=dict(drafter=OracleDrafter(
                    motif, plain["motif"], V, shift=1)))
    if oe.stats.acceptance_rate != 1.0 or oe.stats.draft_tokens == 0:
        raise AssertionError(f"(g) oracle acceptance "
                             f"{oe.stats.acceptance_rate}")
    if ae.stats.accepted_tokens != 0 or ae.stats.draft_tokens == 0:
        raise AssertionError(f"(g) adversarial acceptance "
                             f"{ae.stats.acceptance_rate}")
    run("model_drafter", motif, twin=plain["motif"], speculate="model",
        draft_k=SPEC_K, engine_kw=dict(draft_model=dmodel,
                                       draft_params=dparams))
    plain["int8"], _ = run("plain_int8", motif, kv_dtype="int8")
    run("ngram_int8", motif, twin=plain["int8"], kv_dtype="int8", **spec)
    cp = dict(prefill_chunk=PREFILL_CHUNK, prefix_cache=True)
    plain["chunk_prefix"], _ = run("plain_chunk_prefix", shared, warm=sysp,
                                   **cp)
    _, ce = run("ngram_chunk_prefix", shared, twin=plain["chunk_prefix"],
                warm=sysp, **cp, **spec)
    if ce.stats.prefix_hits < 3 or ce.stats.prefill_chunks == 0 or \
            ce.stats.spec_rounds == 0:
        raise AssertionError(f"(g) chunk + prefix: {ce.stats}")
    out["kernel_launches"] = launches
    out["verify_rounds"] = sum(r["spec_rounds"] for r in out.values()
                               if isinstance(r, dict))
    out["draft_k"] = SPEC_K
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# 9. the fleet: MultiRingEngine over two engines of full-width smollm-135m
# on the one card, under deterministic chaos
# ---------------------------------------------------------------------------

FLEET_CHAOS_ALL = "ring@2,stall@3:1,nan@5,corrupt@8"
FLEET_KW = dict(slots=4, max_seq=512, block_size=128, paged=True,
                paged_kernel="stream", heartbeat_timeout_s=4.0)
# run: (config knobs, engine arguments, chaos kinds that must fire); the
# corrupt@8 of CHAOS_ALL is best effort, as in the reference's test: by
# its step ring 0 may be idle after the migrations
FLEET_RUNS = {
    "i_fault_free": ({}, {}, set()),
    "ii_chaos_all": (dict(chaos=FLEET_CHAOS_ALL), {},
                     {"ring", "stall", "nan"}),
    "iii_corrupt": (dict(chaos="corrupt@4"), {}, {"corrupt"}),
    "iv_nan_window4": (dict(chaos="nan@3", steps_per_sync=4), {}, {"nan"}),
    "v_retries_exhausted": (dict(chaos="ring@2", max_migrations=0), {},
                            {"ring"}),
    "vi_chaos_all_eager": (dict(chaos=FLEET_CHAOS_ALL), dict(graphs=False),
                           {"ring", "stall", "nan"}),
}
RESET_REPEATS = 5


def cache_ptrs(eng):
    return [t.data_ptr() for c in eng.cache.values() for t in c.values()]


def captures_of(eng):
    return eng._programs.captures + eng._admit.captures


def fleet_events(fleet):
    """The fleet's events but the straggler flags (wall-clock verdicts,
    reported apart) and each ring's events, as (kind, step, detail)."""
    return ([(e.kind, e.step, e.detail) for e in fleet.events
             if e.kind != "straggler"],
            [[(e.kind, e.step, e.detail) for e in eng.events]
             for eng in fleet.engines])


def serve_fleet(torch, dev, model, params, prompts, engine_kw=None,
                warm=None, **kw):
    """Serve ``prompts`` x 32 new greedy tokens on a two-ring host fleet
    (4 slots each, the straggler monitors seeded as the serve CLI seeds
    them on the card: with no prior, so their warm-up takes the first
    measured steps); ``warm``: one prompt served first, x 4 tokens.
    Returns (rids, results, fleet, kernel 1 launches)."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.launch.serve import prior_point
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import MultiRingEngine
    conf = EngineConfig(**dict(FLEET_KW, **kw))
    if prior_point(dev) is not None:
        raise AssertionError(f"(9) the serve CLI seeds a roofline prior on "
                             f"{dev}")
    fleet = MultiRingEngine(model, params, None, rings=2, config=conf,
                            step_prior_s=0.0, device=dev,
                            **(engine_kw or {}))
    paged_decode_attention.launches = 0
    if warm is not None:
        fleet.generate([warm], max_new_tokens=4)
    rids = [fleet.submit(p, 32) for p in prompts]
    results = fleet.drain()
    torch.cuda.synchronize()
    return rids, results, fleet, paged_decode_attention.launches


def fleet_record(fleet, rids, results, launches, resets):
    tokens = sum(s.tokens for s in fleet.per_ring_stats())
    straggle = [e.detail for e in fleet.events if e.kind == "straggler"]
    return {"wall_s": fleet.wall, "tokens": tokens,
            "tokens_per_s": fleet.tokens_per_s,
            "fleet_counters": fleet.fleet_counters(),
            "routed": list(fleet.router.routed),
            "failed": {rid: r.error for rid, r in fleet.failed.items()},
            "straggler_events": straggle,
            "ring_failures": [(e.detail["ring"], e.detail["reason"])
                              for e in fleet.events
                              if e.kind == "ring_failed"],
            "resets_checked": resets,
            "kernel_launches": launches,
            "per_ring": [{"tokens": s.tokens,
                          "device_decode_steps": s.device_decode_steps,
                          "graph_captures": s.graph_captures,
                          "graph_replays": s.graph_replays,
                          "ring_failures": s.ring_failures,
                          "migrated_requests": s.migrated_requests,
                          "retries": s.retries}
                         for s in fleet.per_ring_stats()]}


def fleet_gates(torch, model, params, prompts, what, rids, results, fleet,
                launches, fired_want, base):
    """The gates every fleet run passes: kernel 1 launched once per layer
    per device decode step (and chunk and prefix tail) of every ring,
    counted per replay; every ring that served replayed its programs;
    every pool balanced and every floating pool tensor finite after the
    drain; the chaos kinds that must fire fired; every failed request
    out of migrations with its partial stream kept; every stream (a
    failed one up to its length) in agreement with the fault-free
    fleet's ``base``.  Returns the agreement record."""
    want = sum(launches_want(eng) for eng in fleet.engines)
    if launches != want:
        raise AssertionError(f"(9) {what}: kernel 1 launches {launches} != "
                             f"{want}")
    for eng in fleet.engines:
        on_graphs(eng)
        eng.check_pool_balanced()
        for c in eng.cache.values():
            for t in c.values():
                if t.is_floating_point() and \
                        not torch.isfinite(t.float()).all():
                    raise AssertionError(f"(9) {what}: a non-finite pool "
                                         f"tensor on ring {eng.ring_id}")
    fired = {e.detail["kind"] for eng in fleet.engines for e in eng.events
             if e.kind == "chaos"}
    if not fired_want <= fired:
        raise AssertionError(f"(9) {what}: chaos fired {fired}, not "
                             f"{fired_want}")
    for rid, req in fleet.failed.items():
        if not (req.failed and "retries exhausted" in req.error
                and results[rid] == req.out):
            raise AssertionError(f"(9) {what}: request {rid} failed "
                                 f"without its structure: {req.error}")
    if base is None:
        return None
    got = [results[r] for r in rids]
    ref = [b[:len(g)] if rid in fleet.failed else b
           for rid, g, b in zip(rids, got, base)]
    return agree(torch, model, params, prompts, got, ref, f"(9) {what}")


def run_fleet(torch, dev, model, params, prompts, card_name):
    """Phase 9: runs (i)-(vii) of the two-ring fleet at full width, each
    held to its gates (:func:`fleet_gates`), every ``reset()`` checked to
    keep the cache's storage and the ring's captures, then the median
    wall of ``reset()`` on a warmed ring holding 4 requests in flight."""
    import numpy as np
    from repro_torch.serving.engine import LPUEngine
    t0 = time.perf_counter()
    orig_reset, orig_dispatch = LPUEngine.reset, LPUEngine._dispatch_window
    resets, dispatches = [], []

    def checked_reset(self):
        ptrs, caps = cache_ptrs(self), captures_of(self)
        keys = (set(self._programs._by_key), set(self._admit._by_key))
        orphans = orig_reset(self)
        if cache_ptrs(self) != ptrs or captures_of(self) != caps or \
                keys != (set(self._programs._by_key),
                         set(self._admit._by_key)):
            raise AssertionError(f"(9) reset of ring {self.ring_id} moved "
                                 "the cache or changed its programs")
        resets.append(self.ring_id)
        return orphans

    def spy_dispatch(self, win, *a):
        dispatches.append((self.ring_id, self._step_no, win))
        return orig_dispatch(self, win, *a)
    out, streams, events = {}, {}, {}
    LPUEngine.reset = checked_reset
    LPUEngine._dispatch_window = spy_dispatch
    try:
        for name, (kw, engine_kw, fired_want) in FLEET_RUNS.items():
            t_run = time.perf_counter()
            resets.clear()
            dispatches.clear()
            rids, results, fleet, launches = serve_fleet(
                torch, dev, model, params, prompts, engine_kw, **kw)
            rec = fleet_record(fleet, rids, results, launches, len(resets))
            rec["vs_fault_free"] = fleet_gates(
                torch, model, params, prompts, name, rids, results, fleet,
                launches, fired_want, streams.get("i_fault_free"))
            streams[name] = [results[r] for r in rids]
            events[name] = fleet_events(fleet)
            fails = rec["ring_failures"]
            if name != "i_fault_free" and not fails:
                raise AssertionError(f"(9) {name}: no ring failed")
            if name == "i_fault_free" and rec["straggler_events"]:
                raise AssertionError(
                    f"(9) {name}: healthy steps flagged as stragglers: "
                    f"{rec['straggler_events']}")
            if name == "iii_corrupt" and fails[0][1] != "nan_logits":
                raise AssertionError(f"(9) {name}: the corrupted block was "
                                     f"not caught as nan_logits: {fails}")
            if name == "iv_nan_window4":
                fault = next(e for e in fleet.engines[0].events
                             if e.kind == "chaos")
                wins = [w for r, s, w in dispatches
                        if r == 0 and s == fault.step]
                if wins != [4, 4] or fails[0][1] != "nan_logits":
                    raise AssertionError(f"(9) {name}: the fault's step "
                                         f"dispatched {wins}, {fails}")
                rec["windows_in_flight_at_fault"] = wins
            if name == "v_retries_exhausted" and (
                    not fleet.failed or
                    fleet.fleet_counters()["migrated_requests"]):
                raise AssertionError(f"(9) {name}: {rec}")
            if name == "vi_chaos_all_eager" and (
                    streams[name] != streams["ii_chaos_all"]
                    or events[name] != events["ii_chaos_all"]):
                raise AssertionError("(9) the eager twin's streams or "
                                     "events differ from the graphs'")
            if name == "i_fault_free":
                # the median wall of reset() on a warmed ring holding 4
                # requests in flight (2 steps in, then drained in place)
                eng, walls = fleet.engines[0], []
                for _ in range(RESET_REPEATS):
                    for p in prompts[:4]:
                        eng.submit(p, 32)
                    eng.step()
                    eng.step()
                    if eng.sched.num_active() != 4:
                        raise AssertionError("(9) reset timing: 4 requests "
                                             "not in flight")
                    torch.cuda.synchronize()
                    t_r = time.perf_counter()
                    eng.reset()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t_r) * 1e3)
                out["reset_ms"] = {"median": float(np.median(walls)),
                                   "all": walls,
                                   "requests_in_flight": 4,
                                   "cache_bytes": eng.kv_cache_bytes()}
            rec["phase_s"] = time.perf_counter() - t_run
            out[name] = rec
            del fleet
            gc.collect()
        # (vii) prefix affinity: 4 prompts sharing a 256-token system
        # prompt, after that prompt was served on one ring
        t_run = time.perf_counter()
        resets.clear()
        rng = np.random.RandomState(23)
        V = model.cfg.vocab_size
        sysp = [int(t) for t in rng.randint(1, V, size=SYS_PROMPT)]
        shared = [sysp + [int(t) for t in rng.randint(1, V, size=n)]
                  for n in (5, 17, 29, 40)]
        rids, results, fleet, launches = serve_fleet(
            torch, dev, model, params, shared, warm=sysp + [1],
            affinity="prefix", prefix_cache=True)
        owner = 0                        # the warm request went to ring 0
        rec = fleet_record(fleet, rids, results, launches, len(resets))
        plain, _, _ = serve(torch, dev, model, params, shared,
                            paged_kernel="stream")
        rec["vs_single_engine_prefix_off"] = fleet_gates(
            torch, model, params, shared, "vii_prefix_affinity", rids,
            results, fleet, launches, set(), plain)
        hits = fleet.engines[owner].stats.prefix_hits
        if [fleet.ring_of[r] for r in rids] != [owner] * 4 or hits < 4 or \
                fleet.router.affinity_routed[owner] != 4:
            raise AssertionError(f"(9) (vii): routed "
                                 f"{[fleet.ring_of[r] for r in rids]}, "
                                 f"{hits} prefix hits")
        rec.update(prefix_hits=hits, affinity_routed=list(
            fleet.router.affinity_routed), phase_s=time.perf_counter() - t_run)
        out["vii_prefix_affinity"] = rec
        del fleet
        gc.collect()
    finally:
        LPUEngine.reset = orig_reset
        LPUEngine._dispatch_window = orig_dispatch
    out.update(arch=model.cfg.name, rings=2, fleet_kw=FLEET_KW,
               chaos_all=FLEET_CHAOS_ALL, requests=len(prompts), max_new=32,
               kernel_launches=sum(r["kernel_launches"] for r in out.values()
                                   if isinstance(r, dict)
                                   and "kernel_launches" in r),
               phase_s=time.perf_counter() - t0, card=card_name)
    return out


# ---------------------------------------------------------------------------
# phase 10: the async front end
# ---------------------------------------------------------------------------

# the engine phase's engine, in chunks of 64, so the budget has both knobs
# to turn
FRONTEND_KW = dict(slots=4, max_seq=512, block_size=128, paged=True,
                   paged_kernel="stream", prefill_chunk=PREFILL_CHUNK)
# the reference harness's trace (benchmarks/serving_bench.py:379) with its
# prefix aligned to two blocks of 128: bursts of chat turns of two
# tenants, each opening with its tenant's system prompt
FRONTEND_TRACE = dict(seed=7, requests=32, tenants=2, arrival="pareto",
                      rate_rps=200.0, prefix_len=SYS_PROMPT, tail_min=4,
                      tail_max=64, max_new_min=4, max_new_max=32)
FRONTEND_BUDGET_MS = 5.0
FRONTEND_MAX_CHUNK = 512
FRONTEND_MAX_PENDING = 4
FRONTEND_CANCEL_AFTER = 3
FRONTEND_SETTLE = 0.2          # the EWMA has settled within 20% of its end


def percentile(vals, q):
    import numpy as np
    return float(np.percentile(np.asarray(vals, np.float64), q)) \
        if vals else None


def engines_of(eng):
    return list(getattr(eng, "engines", [eng]))


def frontend_engine(dev, model, params, rings=0, **kw):
    """A fresh engine (or a fleet of ``rings``) of FRONTEND_KW + ``kw``."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine, MultiRingEngine
    conf = EngineConfig(**dict(FRONTEND_KW, **kw))
    if rings:
        return MultiRingEngine(model, params, None, rings=rings,
                               config=conf, device=dev)
    return LPUEngine(model, params, conf, device=dev)


def frontend_gates(eng, launches, what):
    """Kernel 1 launched once per layer per device decode step and chunk
    (prefix tails are chunks here) on every engine, counted per replay;
    every engine on its programs; every pool balanced."""
    want = sum(launches_want(e) for e in engines_of(eng))
    if launches != want:
        raise AssertionError(f"(10) {what}: kernel 1 launches {launches} "
                             f"!= {want}")
    for e in engines_of(eng):
        on_graphs(e)
        e.check_pool_balanced()


def serve_blocking(torch, eng, trace):
    """The trace's prompts through blocking ``submit`` / ``drain`` at
    once, each with its own token budget.  Returns (streams in trace
    order, wall, kernel 1 launches)."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(list(r.prompt), r.max_new_tokens) for r in trace]
    res = eng.drain()
    torch.cuda.synchronize()
    return ([res[r] for r in rids], time.perf_counter() - t0,
            paged_decode_attention.launches)


def serve_frontend(torch, eng, trace, drive=None, tracker=None, **fe_kw):
    """One run through ``AsyncFrontend(eng, **fe_kw)``: ``drive(fe,
    trace)`` (default ``serve_trace``, arrivals at the trace's own times)
    gives the streams.  The request and window records go to a ring
    buffer (and ``tracker``).  Returns (front end, streams, records,
    wall, captures made in the run, kernel 1 launches, the host clock
    when the trace's time 0 began)."""
    import asyncio
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.serving.frontend import AsyncFrontend, serve_trace
    from repro_torch.serving.tracker import (CompositeTracker,
                                             RingBufferTracker)
    sink = RingBufferTracker(1 << 16)
    sinks = CompositeTracker([sink] + ([tracker] if tracker else []))
    caps = sum(e.stats.graph_captures for e in engines_of(eng))

    async def go():
        async with AsyncFrontend(eng, tracker=sinks, **fe_kw) as fe:
            start = time.perf_counter()
            streams = await (drive or serve_trace)(fe, trace)
        return fe, streams, start
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    fe, streams, start = asyncio.run(go())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (fe, streams, sink.records(), wall,
            sum(e.stats.graph_captures for e in engines_of(eng)) - caps,
            paged_decode_attention.launches, start)


def frontend_record(trace, fe, streams, records, wall, captures, launches,
                    start):
    """One run's counts, its TTFT and ms/token percentiles from the
    request records (numpy's linear percentile; ms/token over streams of
    2 tokens or more), tokens/s over the run's wall, its captures.  A
    request record's TTFT runs from the submit the front end admitted;
    ``ttft_arrival_ms`` runs from the request's arrival in the trace
    (``start`` + ``arrival_s``), so it also holds the wait for the
    event loop and, for a request rejected and submitted again, the
    time it spent rejected."""
    reqs = [r for r in records if r["kind"] == "request"]
    ttft = [r["ttft_ms"] for r in reqs if r["ttft_ms"] >= 0]
    arrival = [(s.timeline.t_first - start - r.arrival_s) * 1e3
               for r, s in zip(trace, streams)
               if s is not None and s.timeline.t_first is not None]
    mpt = [r["ms_per_token"] for r in reqs if r["tokens"] >= 2]
    tokens = sum(len(s.tokens) for s in streams if s is not None)
    c = fe.counters
    if c["completed"] + c["failed"] + c["cancelled"] != c["submitted"]:
        raise AssertionError(f"(10) the admission ledger is off: {c}")
    return {"completed": c["completed"], "failed": c["failed"],
            "cancelled": c["cancelled"], "rejected": c["rejected"],
            "submitted": c["submitted"],
            "ttft_ms_p50": percentile(ttft, 50),
            "ttft_ms_p99": percentile(ttft, 99),
            "ttft_arrival_ms_p50": percentile(arrival, 50),
            "ttft_arrival_ms_p99": percentile(arrival, 99),
            "ms_per_token_p50": percentile(mpt, 50),
            "ms_per_token_p99": percentile(mpt, 99),
            "request_records": len(reqs),
            "window_records": sum(r["kind"] == "engine_window"
                                  for r in records),
            "tokens": tokens, "tokens_per_s": tokens / wall,
            "graph_captures": captures, "wall_s": wall,
            "kernel_launches": launches}


async def drive_cancel(fe, trace, box):
    """(c): the trace at its own arrival times against ``max_pending``
    (``serve_trace``), then every rejected request submitted again as
    the front end admits it, the one among them with the most tokens to
    make (the victim) cancelled after FRONTEND_CANCEL_AFTER tokens."""
    import asyncio
    from repro_torch.serving.frontend import serve_trace, submit_admitted
    streams = await serve_trace(fe, trace)
    rejected = [i for i, st in enumerate(streams) if st is None]
    if not rejected:
        raise AssertionError("(10) (c): no submit was rejected")
    victim = max(rejected, key=lambda i: trace[i].max_new_tokens)
    box.update(victim=victim, rejected_on_arrival=rejected,
               rejected_on_retry=0)

    async def cancel_after(stream):
        got = 0
        async for _ in stream:
            got += 1
            if got == FRONTEND_CANCEL_AFTER:
                box["cancel_landed"] = await stream.cancel()
                return
    tasks = []
    for i in rejected:
        r = trace[i]
        streams[i], n = await submit_admitted(fe, r.prompt, r.max_new_tokens,
                                              tenant=r.tenant)
        box["rejected_on_retry"] += n
        if i == victim:
            tasks.append(asyncio.create_task(cancel_after(streams[i])))
    await fe.join()
    for t in tasks:
        await t
    return streams


def released(ref, what):
    """Raise unless the engine behind the weak reference ``ref`` is gone
    once its run's names are deleted: an engine in a reference cycle
    through the front end would hold its graphs and pool until the
    cyclic collector's next pass."""
    if ref() is not None:
        raise AssertionError(f"(10) {what}: the engine outlived its run "
                             "(a reference cycle)")


def budget_trail(recs, prior):
    """(b)'s budget replayed from the run's ``engine_window`` records: a
    BudgetScheduler seeded as (b)'s was observes each record's tick,
    its own plan giving the tick's chunk width, as (b)'s plan did.
    Returns (the replay, its mu_step after each observed window)."""
    from repro_torch.serving.budget import BudgetScheduler
    replay = BudgetScheduler(FRONTEND_BUDGET_MS, prior_step_s=prior,
                             max_chunk=FRONTEND_MAX_CHUNK)
    trail = []
    for r in recs:
        if r["kind"] != "engine_window":
            continue
        d, (chunk, _) = r["delta"], replay.plan()
        seen = replay.observed_windows
        replay.observe_tick(r["dt_ms"] / 1e3, d["steps"],
                            d["prefill_chunks"], d["prefill_chunks"] * chunk)
        if replay.observed_windows > seen:
            trail.append(replay.mu_step)
    return replay, trail


def run_frontend(torch, dev, model, params, card_name):
    """Phase 10: the trace FRONTEND_TRACE through ``AsyncFrontend`` on
    fresh engines of full-width smollm-135m (captures inside each run's
    wall): the blocking run of its prompts, (a) budget off, (b) budget
    on (BudgetScheduler seeded as the serve CLI seeds it on the card:
    with no prior, so its EWMA starts from the budget itself), (c) cancel
    and backpressure, (d) a two-ring prefix-affinity fleet with the
    prefix cache and a jsonl tracker.  Every stream held to its twin by
    :func:`agree`, kernel 1's launches exact per replay, every pool
    balanced, every engine freed by reference count after its run."""
    import tempfile
    import weakref
    from repro_torch.launch.serve import prior_point
    from repro_torch.serving.budget import BudgetScheduler
    from repro_torch.serving.traces import TraceConfig, generate_trace
    from repro_torch.serving.tracker import (JsonlTracker, counter_fields,
                                             read_jsonl, snapshot_stats)
    t0 = time.perf_counter()
    trace = generate_trace(TraceConfig(**FRONTEND_TRACE,
                                       vocab=model.cfg.vocab_size))
    prompts = [list(r.prompt) for r in trace]
    out = {"trace": dict(FRONTEND_TRACE, vocab=model.cfg.vocab_size,
                         arrivals_s=[r.arrival_s for r in trace],
                         prompt_lens=[len(p) for p in prompts],
                         max_new=[r.max_new_tokens for r in trace])}
    launches = 0

    # the blocking run of the same prompts on a fresh engine
    eng = frontend_engine(dev, model, params)
    base, wall, n = serve_blocking(torch, eng, trace)
    frontend_gates(eng, n, "blocking")
    launches += n
    out["blocking"] = {"tokens": sum(map(len, base)), "wall_s": wall,
                       "tokens_per_s": sum(map(len, base)) / wall,
                       "graph_captures": eng.stats.graph_captures,
                       "kernel_launches": n}
    ref = weakref.ref(eng)
    del eng
    released(ref, "blocking")

    # (a) budget off
    eng = frontend_engine(dev, model, params)
    run = serve_frontend(torch, eng, trace)
    fe, streams, recs, _, _, n, _ = run
    frontend_gates(eng, n, "(a)")
    launches += n
    a_streams = [s.tokens for s in streams]
    out["a_budget_off"] = dict(
        frontend_record(trace, *run),
        vs_blocking=agree(torch, model, params, prompts, a_streams, base,
                          "(10) (a) against blocking"))
    ref = weakref.ref(eng)
    del eng, fe, streams, run
    released(ref, "(a)")

    # (b) budget on
    eng = frontend_engine(dev, model, params)
    if prior_point(dev) is not None:
        raise AssertionError(f"(10) the serve CLI seeds a roofline prior on "
                             f"{dev}")
    prior = 0.0
    bud = BudgetScheduler(FRONTEND_BUDGET_MS, prior_step_s=prior,
                          max_chunk=FRONTEND_MAX_CHUNK)
    run = serve_frontend(torch, eng, trace, budget=bud)
    fe, streams, recs, _, _, n, _ = run
    frontend_gates(eng, n, "(b)")
    launches += n
    if not bud.planned or not bud.observed_windows:
        raise AssertionError(f"(10) (b): {len(bud.planned)} plans, "
                             f"{bud.observed_windows} windows observed")
    replay, trail = budget_trail(recs, prior)
    if (replay.observed_windows, replay.observed_chunks) != \
            (bud.observed_windows, bud.observed_chunks) or \
            abs(replay.mu_step - bud.mu_step) > 1e-9 * bud.mu_step or \
            abs(replay.mu_tok - bud.mu_tok) > 1e-9 * bud.mu_tok:
        raise AssertionError("(10) (b): the budget replayed from the "
                             "window records is not the run's budget")
    end = trail[-1]
    settled = next(k for k in range(len(trail))
                   if all(abs(x - end) <= FRONTEND_SETTLE * end
                          for x in trail[k:]))
    out["b_budget_on"] = dict(
        frontend_record(trace, *run),
        budget_ms=FRONTEND_BUDGET_MS, prior_step_ms=prior * 1e3,
        max_chunk=FRONTEND_MAX_CHUNK, plans=len(bud.planned),
        distinct_plans=sorted({(c, s) for c, s in bud.planned}),
        first_plans=bud.planned[:8],
        observed_windows=bud.observed_windows,
        observed_chunks=bud.observed_chunks,
        mu_step_ms=bud.mu_step * 1e3, mu_tok_ms=bud.mu_tok * 1e3,
        mu_step_trail_ms=[x * 1e3 for x in trail[:16]],
        windows_to_settle=settled,
        programs=sorted(str(k) for k in (*eng._programs._by_key,
                                         *eng._admit._by_key)),
        vs_a=agree(torch, model, params, prompts,
                   [s.tokens for s in streams], a_streams,
                   "(10) (b) against (a)"))
    ref = weakref.ref(eng)
    del eng, fe, streams, run
    released(ref, "(b)")

    # (c) cancel and backpressure
    eng = frontend_engine(dev, model, params)
    box = {}
    run = serve_frontend(torch, eng, trace,
                         drive=lambda f, t: drive_cancel(f, t, box),
                         max_pending=FRONTEND_MAX_PENDING)
    fe, streams, _, _, _, n, _ = run
    victim = box["victim"]
    frontend_gates(eng, n, "(c)")
    launches += n
    got = [s.tokens for s in streams]
    if not box.get("cancel_landed") or streams[victim].status != \
            "cancelled" or eng.stats.cancelled_requests != 1 or \
            fe.counters["cancelled"] != 1 or not fe.counters["rejected"] \
            or len(got[victim]) >= trace[victim].max_new_tokens:
        raise AssertionError(f"(10) (c): {box}, {fe.counters}, "
                             f"cancelled_requests "
                             f"{eng.stats.cancelled_requests}, victim "
                             f"{len(got[victim])} tokens")
    out["c_cancel_backpressure"] = dict(
        frontend_record(trace, *run),
        max_pending=FRONTEND_MAX_PENDING,
        victim_tokens=len(got[victim]), **box,
        cancelled_requests=eng.stats.cancelled_requests,
        vs_blocking=agree(torch, model, params, prompts, got,
                          [b[:len(g)] if i == victim else b
                           for i, (g, b) in enumerate(zip(got, base))],
                          "(10) (c) against blocking"))
    ref = weakref.ref(eng)
    del eng, fe, streams, run
    released(ref, "(c)")

    # (d) the fleet: two rings, prefix affinity, the prefix cache, jsonl
    fleet = frontend_engine(dev, model, params, rings=2, affinity="prefix",
                            prefix_cache=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frontend.jsonl")
        run = serve_frontend(torch, fleet, trace, tracker=JsonlTracker(path))
        back = read_jsonl(path)
    fe, streams, _, _, _, n, _ = run
    frontend_gates(fleet, n, "(d)")
    launches += n
    reqs = [r for r in back if r["kind"] == "request"]
    if len(reqs) != len(trace) or \
            sorted(r["rid"] for r in reqs) != list(range(len(trace))):
        raise AssertionError(f"(10) (d): {len(reqs)} request records for "
                             f"{len(trace)} requests")
    for i, e in enumerate(fleet.engines):
        sums = dict.fromkeys(counter_fields(e.stats), 0)
        for r in back:
            if r["kind"] == "engine_window" and r["ring"] == i:
                for k, v in r["delta"].items():
                    sums[k] += v
        if sums != snapshot_stats(e.stats):
            raise AssertionError(f"(10) (d) ring {i}: the window deltas "
                                 "do not sum to its counters")
    st = fleet.per_ring_stats()
    out["d_fleet"] = dict(
        frontend_record(trace, *run),
        jsonl_records=len(back), routed=list(fleet.router.routed),
        affinity_routed=list(fleet.router.affinity_routed),
        prefix_hits=sum(s.prefix_hits for s in st),
        prefix_lookups=sum(s.prefix_lookups for s in st),
        prefill_tokens_saved=sum(s.prefill_tokens_saved for s in st),
        vs_blocking=agree(torch, model, params, prompts,
                          [s.tokens for s in streams], base,
                          "(10) (d) against blocking"))
    ref = weakref.ref(fleet)
    del fleet, fe, streams, st, run
    released(ref, "(d)")
    out.update(arch=model.cfg.name, engine_kw=FRONTEND_KW,
               kernel_launches=launches,
               phase_s=time.perf_counter() - t0, card=card_name)
    return out


# the C1 chain: 8 teacher-forced decode steps in six variants, named
# (cache, paged dataflow, w_dtype) (32 steps before phase 13 joined the
# run, 16 until the one-card run passed 900 s)
CHAIN_STEPS = 8
CHAIN_VARIANTS = (("stream", "pool", "stream", "auto"),
                  ("gather", "pool", "gather", "auto"),
                  ("dense", "dense", "auto", "auto"),
                  ("int8_pool", "int8", "stream", "auto"),
                  ("fp8_pool", "fp8", "stream", "auto"),
                  ("int8_weights", "pool", "stream", "int8"))
# largest |logit| difference allowed, kernels vs plain and (fp variants)
# chain vs the model's decode: f32 end to end, only the order of sums
# differs.  Quantized pools: kernels and plain quantize new rows from K/V
# that differ in the last bits, so a row may round one step apart.
CHAIN_TOL = 1e-4
CHAIN_TOL_QUANT = 1e-2
CHUNK_C = 64


def _reset_counts():
    from repro_torch.kernels import reset_launches
    reset_launches()


def _read_counts():
    """{wrapper: launches} of the port's one registry of counted kernel
    wrappers (``repro_torch.kernels.counted``); a replayed graph adds the
    launches its capture made."""
    from repro_torch.kernels import read_launches
    return read_launches()


def run_chain(torch, ctx, cache0, tables, use_kernels, paged_kernel,
              w_dtype):
    """CHAIN_STEPS teacher-forced steps of decode_layer stacked over the
    layers, from a copy of ``cache0``; -> (logits (steps, B, V_pad), wall
    s)."""
    from repro_torch.core import streamline as sl
    from repro_torch.models.common import apply_norm
    from repro_torch.models.transformer import (add_positional,
                                                embed_tokens, lm_logits)
    cfg, plan, params = ctx["cfg"], ctx["plan"], ctx["params"]
    cache = {k: v.clone() for k, v in cache0.items()}
    layers = [{k: v[i] for k, v in cache.items()}
              for i in range(cfg.n_layers)]
    pos = ctx["lens"].clone()
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(CHAIN_STEPS):
        # the token's embedding and, for learned positions (OPT), its
        # position's row, as the model's forward adds them
        x = add_positional(params, embed_tokens(
            params, ctx["tokens"][step][:, None], cfg, plan),
            pos[:, None], cfg)[:, 0]
        for i, lp in enumerate(ctx["layers"]):
            x, _ = sl.decode_layer(lp, x, layers[i], pos, cfg=cfg, plan=plan,
                                   use_kernels=use_kernels,
                                   block_table=tables,
                                   paged_kernel=paged_kernel,
                                   w_dtype=w_dtype)
        out.append(lm_logits(params, apply_norm(params["ln_f"], x,
                                                cfg.norm), cfg, plan))
        pos = pos + 1
    torch.cuda.synchronize()
    return torch.stack(out), time.perf_counter() - t0


def chain_context(torch, dev, model=None, params=None):
    """Full-width smollm-135m (f32, random weights from seed 0; or the
    given ``model`` and ``params``), the engine phase's first 4 prompts
    prefilled by the model into a paged pool (block 128, max_seq 512)
    and a dense cache, and the model's own greedy decode: its tokens
    drive every variant (teacher forcing), its logits are the
    reference."""
    import numpy as np
    from repro_torch.models.transformer import layer_params
    from repro_torch.serving.kv_cache import (scatter_prefill_dense,
                                              scatter_prefill_pages)
    if model is None:
        model, params, _ = smollm(torch, dev)
    cfg, plan = model.cfg, model.plan
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                            size=rng.randint(2, 65))]
               for _ in range(8)][:4]
    max_seq, bs = 512, 128
    T = max_seq // bs
    nb = 1 + len(prompts) * T
    tables = (1 + torch.arange(len(prompts) * T, dtype=torch.int32,
                               device=dev)).reshape(len(prompts), T)
    pool = model.init_cache(len(prompts), max_seq, paged=True,
                            num_blocks=nb, block_size=bs)
    dense = model.init_cache(len(prompts), max_seq)
    first = []
    for b, pr in enumerate(prompts):
        buf = torch.zeros((1, bs), dtype=torch.long, device=dev)
        buf[0, :len(pr)] = torch.tensor(pr, device=dev)
        logits, pc = model.forward(params, buf, mode="prefill",
                                   cache=model.init_cache(1, bs),
                                   positions=torch.arange(bs,
                                                          device=dev)[None])
        first.append(int(logits[0, len(pr) - 1].argmax()))
        scatter_prefill_pages(pool, pc, tables[b, :1])
        scatter_prefill_dense(dense, pc, b)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    caches = {"pool": {k: v.clone() for k, v in pool["l0"].items()},
              "dense": {k: v.clone() for k, v in dense["l0"].items()}}
    # the model's own greedy decode (paged, streamed through kernel 1)
    tok = torch.tensor(first, device=dev)
    tokens, ref = [], []
    pos = lens.clone()
    for _ in range(CHAIN_STEPS):
        tokens.append(tok)
        logits, _ = model.forward(params, tok[:, None], mode="decode",
                                  positions=pos, cache=pool,
                                  block_tables=tables,
                                  paged_kernel="stream")
        ref.append(logits[:, -1])
        tok = logits[:, -1].argmax(-1)
        pos = pos + 1
    return {"cfg": cfg, "plan": plan, "params": params, "tables": tables,
            "lens": lens, "tokens": tokens, "ref": torch.stack(ref),
            "caches": caches, "prompt_lens": [len(p) for p in prompts],
            "layers": [layer_params(params, i)["l0"]
                       for i in range(cfg.n_layers)]}


def quantized_cache(torch, cache, qdt):
    from repro_torch.serving.kv_cache import quantize_kv_rows
    out = {}
    for key in ("k", "v"):
        out[key], out[key + "_scale"] = quantize_kv_rows(cache[key], qdt,
                                                         torch.float16)
    return out


def top2_gap(logits):
    top = logits.topk(2, -1).values
    return top[..., 0] - top[..., 1]


def run_chain_phase(torch, dev, ctx=None, names=None):
    """The six variants (or those ``names``), kernels and plain; launch
    counts, tolerances and argmax checks; times per step.  Returns the
    ``chain`` record."""
    ctx = ctx or chain_context(torch, dev)
    n_steps, L = CHAIN_STEPS, ctx["cfg"].n_layers
    B_ = len(ctx["prompt_lens"])
    caches = dict(ctx["caches"])
    run = [v for v in CHAIN_VARIANTS if names is None or v[0] in names]
    if any(kind in ("int8", "fp8") for _, kind, _, _ in run):
        caches["int8"] = quantized_cache(torch, caches["pool"], torch.int8)
        caches["fp8"] = quantized_cache(torch, caches["pool"],
                                        torch.float8_e4m3fn)
    ref, ref_gap = ctx["ref"], top2_gap(ctx["ref"])
    ref_arg = ref.argmax(-1)
    variants, logits_of, walls = {}, {}, {}
    total = dict.fromkeys(_read_counts(), 0)
    for name, kind, mode, w_dtype in run:
        tables = None if kind == "dense" else ctx["tables"]
        cache0 = caches[kind]
        _reset_counts()
        got, _ = run_chain(torch, ctx, cache0, tables, True, mode, w_dtype)
        counts = _read_counts()
        for k in total:
            total[k] += counts[k]
        attn = "decode_attention" if kind == "dense" or mode == "gather" \
            else "paged_decode_attention"
        want_counts = dict.fromkeys(counts, 0)
        want_counts["gemv"] = 4 * L * n_steps
        want_counts[attn] = L * n_steps
        if counts != want_counts:
            raise AssertionError(f"chain {name}: launches {counts}, "
                                 f"expected {want_counts}")
        _, wall = run_chain(torch, ctx, cache0, tables, True, mode, w_dtype)
        plain, plain_wall = run_chain(torch, ctx, cache0, tables, False,
                                      mode, w_dtype)
        if not torch.isfinite(got).all():
            raise AssertionError(f"chain {name}: non-finite logits")
        quant = kind in ("int8", "fp8")
        tol = CHAIN_TOL_QUANT if quant else CHAIN_TOL
        err = (got - plain).abs().max().item()
        if err > tol:
            raise AssertionError(f"chain {name}: kernels vs plain max abs "
                                 f"{err} > {tol}")
        rec = {"ms_per_step": wall / n_steps * 1e3,
               "tokens_per_s": B_ * n_steps / wall,
               "plain_ms_per_step": plain_wall / n_steps * 1e3,
               "max_abs_err_vs_plain": err, "tol_vs_plain": tol,
               "launches_per_step": {k: v / n_steps
                                     for k, v in counts.items()}}
        arg = got.argmax(-1)
        if not quant and w_dtype == "auto":
            err_m = (got - ref).abs().max().item()
            if err_m > CHAIN_TOL:
                raise AssertionError(f"chain {name}: vs model decode max "
                                     f"abs {err_m} > {CHAIN_TOL}")
            decided = ref_gap > CHAIN_TOL
            if not torch.equal(arg[decided], ref_arg[decided]):
                raise AssertionError(f"chain {name}: greedy argmax differs "
                                     "from the model's where its top-2 "
                                     f"gap exceeds {CHAIN_TOL}")
            rec.update(max_abs_err_vs_model=err_m, tol_vs_model=CHAIN_TOL,
                       argmax_checked=int(decided.sum()),
                       argmax_total=int(decided.numel()))
        else:
            rec["argmax_agree_with_fp_stream"] = float(
                (arg == logits_of["stream"].argmax(-1)).float().mean())
            rec["max_abs_diff_vs_model"] = (got - ref).abs().max().item()
        variants[name] = rec
        logits_of[name] = got
        walls[name] = wall
    return ctx, {"arch": ctx["cfg"].name, "n_layers": L,
                 "d_model": ctx["cfg"].d_model, "dtype": "float32",
                 "batch": B_, "prompt_lens": ctx["prompt_lens"],
                 "steps": n_steps, "block_size": 128, "max_seq": 512,
                 "ref_logit_std":
                     ref[..., :ctx["cfg"].vocab_size].std().item(),
                 "ref_top2_gap_min": ref_gap.min().item(),
                 "variants": variants}, total, walls


def chunk_vs_sequential(torch, dev, ctx, mode):
    """chunk_prefill_layer on one full-width layer (C = 64 rows) against
    64 sequential decode_layer calls on a fresh pool, attending through
    the paged kernel ("stream") or the dense kernel over the gathered,
    broadcast view ("gather").  Also whether the layer's first steps,
    the norm and the QKV gemv, give each row the same bits in the chunk
    as alone: where they do not, the chunk and the sequential run start
    from different inputs."""
    from repro_torch.core import streamline as sl
    from repro_torch.kernels.gemv.ops import gemv
    from repro_torch.models.common import apply_norm
    cfg, plan = ctx["cfg"], ctx["plan"]
    a = plan.attn
    p = ctx["layers"][0]
    g = torch.Generator(device=dev).manual_seed(5)
    xs = torch.randn((CHUNK_C, cfg.d_model), generator=g, device=dev)
    table = torch.arange(1, 5, dtype=torch.int32, device=dev)

    def fresh():
        return {k: torch.zeros((5, 128, a.gp, a.d_head), device=dev)
                for k in "kv"}
    y_c, pool_c = sl.chunk_prefill_layer(p, xs, fresh(), table, 0, CHUNK_C,
                                         cfg=cfg, plan=plan,
                                         paged_kernel=mode)
    pool_s, ys = fresh(), []
    for i in range(CHUNK_C):
        y, _ = sl.decode_layer(p, xs[i:i + 1], pool_s,
                               torch.tensor([i], dtype=torch.int32,
                                            device=dev),
                               cfg=cfg, plan=plan, block_table=table[None],
                               paged_kernel=mode)
        ys.append(y)
    y_s = torch.cat(ys)
    h = apply_norm(p["ln1"], xs, cfg.norm)
    h_rows = torch.cat([apply_norm(p["ln1"], xs[i:i + 1], cfg.norm)
                        for i in range(CHUNK_C)])
    wq = p["attn"]["wq"].reshape(cfg.d_model, -1)
    torch.cuda.synchronize()
    if not torch.isfinite(y_c).all():
        raise AssertionError(f"chunk_prefill_layer {mode}: non-finite output")
    err_y = (y_c - y_s).abs().max().item()
    err_kv = max((pool_c[k] - pool_s[k]).abs().max().item() for k in "kv")
    if err_y > CHAIN_TOL or err_kv > CHAIN_TOL:
        raise AssertionError(f"chunk vs sequential ({mode}): {err_y}, "
                             f"{err_kv} > {CHAIN_TOL}")
    gemv_rows_equal = torch.equal(
        gemv(h_rows, wq), torch.cat([gemv(h_rows[i:i + 1], wq)
                                     for i in range(CHUNK_C)]))
    if not gemv_rows_equal:
        raise AssertionError("gemv: a row of the chunk differs from the "
                             "same row alone")
    return {"C": CHUNK_C, "mode": mode, "max_abs_diff_y": err_y,
            "max_abs_diff_pool": err_kv, "tol": CHAIN_TOL,
            "exact": bool(torch.equal(y_c, y_s) and all(
                torch.equal(pool_c[k], pool_s[k]) for k in "kv")),
            "norm_rows_bit_equal": bool(torch.equal(h, h_rows)),
            "norm_rows_max_abs_diff": (h - h_rows).abs().max().item(),
            "gemv_rows_bit_equal": gemv_rows_equal}


# the port's kernels on the chain, by the names the profiler shows
CHAIN_KERNELS = ("gemv_kernel", "dense_decode_kernel", "paged_decode_kernel")


def profile_chain(torch, ctx, tables, mode, wall):
    """torch.profiler over one kernel run of a chain variant: device busy
    share against the unprofiled wall time, the concatenations' and each
    port kernel's device ms per step, and the top kernels."""
    cache = ctx["caches"]["pool" if tables is not None else "dense"]
    kernels = device_kernels(lambda: run_chain(torch, ctx, cache, tables,
                                               True, mode, "auto"))
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    cat_us = sum(e.self_device_time_total for e in kernels
                 if "CatArray" in e.key or "cat" in e.key.lower())
    per_kernel = {}
    for name in CHAIN_KERNELS:
        hits = [e for e in kernels if name in e.key]
        if hits:
            us = sum(e.self_device_time_total for e in hits)
            n = sum(e.count for e in hits)
            per_kernel[name] = {"launches": n,
                                "device_ms_per_step": us / 1e3 / CHAIN_STEPS,
                                "us_per_launch": us / n}
    return {"device_busy_ms": busy_us / 1e3,
            "unprofiled_wall_ms": wall * 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "device_ms_per_step": busy_us / 1e3 / CHAIN_STEPS,
            "cat_device_ms_per_step": cat_us / 1e3 / CHAIN_STEPS,
            "port_kernels": per_kernel,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def chain_costs(torch, ctx, walls):
    """torch.profiler over the stream and the dense variants, and the
    wall time of one decode step's per-call weight work run on its own:
    the wq|wk|wv and wg|wu concatenations, and the int8 quantization of
    every weight (w_dtype="int8")."""
    from repro_torch.kernels.gemv.ops import quantize_weight
    D = ctx["cfg"].d_model
    a = ctx["plan"].attn

    def concat(_):
        for lp in ctx["layers"]:
            torch.cat([lp["attn"]["wq"].reshape(D, -1),
                       lp["attn"]["wk"].reshape(D, -1),
                       lp["attn"]["wv"].reshape(D, -1)], -1)
            torch.cat([lp["mlp"]["wg"], lp["mlp"]["wu"]], -1)

    def quantize(_):
        for lp in ctx["layers"]:
            quantize_weight(torch.cat([lp["attn"]["wq"].reshape(D, -1),
                                       lp["attn"]["wk"].reshape(D, -1),
                                       lp["attn"]["wv"].reshape(D, -1)], -1))
            quantize_weight(lp["attn"]["wo"].reshape(a.hp * a.d_head, D))
            quantize_weight(torch.cat([lp["mlp"]["wg"], lp["mlp"]["wu"]],
                                      -1))
            quantize_weight(lp["mlp"]["wd"])
    def wall_ms(fn, n=10):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    return {"profile_stream": profile_chain(torch, ctx, ctx["tables"],
                                            "stream", walls["stream"]),
            "profile_dense": profile_chain(torch, ctx, None, "auto",
                                           walls["dense"]),
            "per_step_weight_concat_wall_ms": wall_ms(concat),
            "per_step_weight_quantize_wall_ms": wall_ms(quantize)}


# ---------------------------------------------------------------------------
# (h) the paper's own models: opt-1.3b at full width through the engine
# and the chain, kernels 1 and 3 at OPT's shapes, and the paper's
# protocol at batch 1 on opt-1.3b and opt-6.7b
# ---------------------------------------------------------------------------

# the paper's measurement protocol and published figures, copied from
# benchmarks/paper_constants.py (IN_TOKENS, OUT_TOKENS; PAPER_LATENCY,
# PAPER_SPEEDUP_VS_GPU, PAPER_BW_UTIL, PAPER_GPU_BW_UTIL at batch 1): the
# port imports nothing of the reference's benchmarks.  They are the
# paper's numbers, printed beside the port's, never as the port's.
PAPER_IN_TOKENS, PAPER_OUT_TOKENS = 32, 2016
PAPER = {"opt-1.3b": {"lpu_ms_per_token": 1.25, "gpu_slower_x": 2.09,
                      "lpu_bandwidth_use": 0.633,
                      "gpu_bandwidth_use": 0.289},
         "opt-6.7b": {"lpu_ms_per_token": 4.62}}
# the outputs are cut from the protocol's 2016 tokens to keep the run
# inside its limit (the engine's steps are paced by the host; PERF.md
# §4): 512 for opt-1.3b (mean length 288), 256 for opt-6.7b (mean
# length 160)
# new tokens of the protocol on captured windows, and on the eager twin
# (whose stream must equal the first tokens of the graphs' one; 128 each
# since phase 13 joined the run, 512 and 256 before)
OPT_OUT = {"opt-1.3b": PAPER_OUT_TOKENS, "opt-6.7b": 256}
OPT_EAGER_OUT = {"opt-1.3b": 128, "opt-6.7b": 128}
OPT_MAX_SEQ = 2048
OPT_WINDOW = 8                 # steps_per_sync of the protocol's engine
OPT_PROFILE_STEPS = 64         # decode steps under torch.profiler
OPT_BIAS_STD = 0.02
OPT_BIAS_LEAVES = ("bq", "bk", "bv", "bi", "bd", "bias")
OPT_REDRAW_SEED = 20
# kernel 1 at the protocol's shape: batch 1, OPT's 32 heads over 32 kv
# heads, blocks of 128 under max_seq 2048 (T 16), the mean length of
# in 32 + out 2016, bf16; dh 64 (opt-1.3b) and 128 (opt-6.7b)
OPT_K1_HEADS, OPT_K1_T, OPT_K1_LEN = 32, 16, 1040
OPT_K1_DH = (64, 128)
# opt-1.3b's four gemvs of a layer (the qkv, fc1 and fc2 with their
# bias; OPT's out projection has none in the reference's init)
OPT_GEMV_SHAPES = (("qkv", 2048, 6144, True), ("o", 2048, 2048, False),
                   ("fc1", 2048, 8192, True), ("fc2", 8192, 2048, True))


def opt_std(cfg):
    """{leaf name: std} of the leaves an OPT or GPT3 model redraws: every
    bias N(0, 0.02^2), ``pos_embed`` its init law N(0, 1/max_seq)."""
    return dict(dict.fromkeys(OPT_BIAS_LEAVES, OPT_BIAS_STD),
                pos_embed=1.0 / math.sqrt(cfg.max_seq))


def opt_model(torch, dev, name, dtype="float32"):
    """Full-width ``name`` with random weights drawn on the card by
    ``init_params`` (seed 0), then every bias leaf and ``pos_embed``
    redrawn (``weights.redraw``, :func:`opt_std`, seed OPT_REDRAW_SEED):
    the init's zero biases would leave every bias add, kernel 3's
    included, adding nothing."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build_model
    from repro_torch.weights import redraw
    cfg = get_config(name)
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype=dtype, param_dtype=dtype)
    model = build_model(cfg, plan, dev)
    params = init_params(cfg, plan, seed=0, device=dev)
    redraw(params, opt_std(cfg), OPT_REDRAW_SEED)
    return model, params


def rank_weights(cfg, plan, rank, dev):
    """Rank ``rank``'s shard of full-width ``cfg`` on ``plan``'s ring,
    the values the tp=1 phases draw (``init_params`` seed 0; an OPT or
    GPT3 model's biases and positions redrawn as :func:`opt_model` does),
    drawn without the full tree (``weights.init_shard``,
    ``weights.redraw_shard``)."""
    from repro_torch.weights import init_shard, redraw_shard
    params = init_shard(cfg, plan, rank, seed=0, device=dev)
    if cfg.positional == "learned":
        redraw_shard(params, cfg, plan, rank, opt_std(cfg), OPT_REDRAW_SEED)
    return params


def opt_prompts(cfg):
    """The engine phase's traffic over OPT's vocabulary: 8 seeded prompts
    of 2-64 tokens, and 4 prompts sharing a 256-token system prompt."""
    import numpy as np
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                            size=rng.randint(2, 65))]
               for _ in range(8)]
    rng = np.random.RandomState(20)
    sysp = [int(t) for t in rng.randint(1, cfg.vocab_size, size=SYS_PROMPT)]
    shared = [sysp + [int(t) for t in rng.randint(1, cfg.vocab_size,
                                                  size=n)]
              for n in (5, 17, 29, 40)]
    return prompts, sysp, shared


def path_counts(want_nonzero, what, counts=None):
    """The kernels' launch counts since the last _reset_counts (or
    ``counts``); raises unless each kernel the path runs launched and no
    other did."""
    counts = counts or _read_counts()
    for k, v in counts.items():
        if (v > 0) != (k in want_nonzero):
            raise AssertionError(f"{what}: launches {counts}, expected "
                                 f"exactly {sorted(want_nonzero)} > 0")
    return counts


def run_opt_engine(torch, dev, model, params):
    """(h1): full-width opt-1.3b in f32 through the engine, as the smollm
    engine phase serves smollm-135m: kernel 1 against the gather oracle,
    a run that preempts against the uncontended one, and one run in
    chunks of 64 with the prefix cache on (the shared system prompt
    served alone first, so it is indexed) against the monolithic run;
    streams equal or apart only at a top-2 gap <= 1e-4, kernel 1's
    launches exact, the pool balanced after every run."""
    cfg = model.cfg
    prompts, sysp, shared = opt_prompts(cfg)
    _reset_counts()
    _, _, warm = serve(torch, dev, model, params, prompts[:2],
                       paged_kernel="stream")
    stream, eng, launches = serve(torch, dev, model, params, prompts,
                                  paged_kernel="stream")
    if launches != launches_want(eng) or not launches:
        raise AssertionError(f"(h1) kernel launches {launches} != "
                             f"{launches_want(eng)}")
    for o in stream:
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"(h1) bad stream {o}")
    pool_checks(eng, "(h1) stream")
    gather, geng, gl = serve(torch, dev, model, params, prompts,
                             paged_kernel="gather")
    if gl != 0:
        raise AssertionError("(h1) the gather oracle launched the kernel")
    pool_checks(geng, "(h1) gather")
    pre, peng, pl = serve(torch, dev, model, params, prompts,
                          paged_kernel="stream", block_size=32,
                          num_blocks=7, steps_per_sync=4)
    if peng.stats.preemptions == 0:
        raise AssertionError("(h1) the small pool did not preempt")
    if pl != launches_want(peng):
        raise AssertionError(f"(h1) preempted launches {pl}")
    pool_checks(peng, "(h1) preempted")
    mono, meng, ml = serve(torch, dev, model, params, shared,
                           paged_kernel="stream")
    pool_checks(meng, "(h1) monolithic")
    chunked, ceng, cl = serve(torch, dev, model, params, shared,
                              paged_kernel="stream", warm=sysp,
                              prefill_chunk=PREFILL_CHUNK, prefix_cache=True)
    cs = ceng.stats
    if cs.prefix_hits < 4 or not cs.prefill_chunks or cs.decode_stalls:
        raise AssertionError(f"(h1) chunked + prefix: {cs}")
    if cl != launches_want(ceng):
        raise AssertionError(f"(h1) chunked launches {cl} != "
                             f"{launches_want(ceng)}")
    pool_checks(ceng, "(h1) chunked + prefix")
    # serve() zeroes kernel 1's count per run: the path's is their sum
    counts = _read_counts()
    counts["paged_decode_attention"] = warm + launches + gl + pl + ml + cl
    counts = path_counts({"paged_decode_attention"}, "(h1)", counts)
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.d_head],
        "dtype": "float32", "slots": 4, "max_seq": 512, "block_size": 128,
        "requests": len(prompts), "max_new": 32,
        "distinct_tokens_per_stream": [len(set(o)) for o in stream],
        "stream": run_rec(eng, launches),
        "gather": run_rec(geng, gl, vs_stream=agree(
            torch, model, params, prompts, gather, stream, "(h1) gather")),
        "preempt": run_rec(peng, pl, block_size=32, num_blocks=7,
                           steps_per_sync=4, vs_uncontended=agree(
                               torch, model, params, prompts, pre, stream,
                               "(h1) preempted")),
        "monolithic_shared": run_rec(meng, ml),
        "chunked_prefix": run_rec(ceng, cl, chunk=PREFILL_CHUNK,
                                  decode_stalls=cs.decode_stalls,
                                  vs_monolithic=agree(
                                      torch, model, params, shared, chunked,
                                      mono, "(h1) chunked + prefix")),
        "launches": counts, "streams": stream}


def run_opt_chain(torch, dev, model, params):
    """(h2): the C1 chain over opt-1.3b's 24 layers at 4 rows, its
    stream (kernels 1 and 3) and dense (kernels 2 and 3) variants
    against their plain versions and the model's own decode, exact
    launches, and a torch.profiler pass of the stream variant."""
    ctx = chain_context(torch, dev, model, params)
    # run_chain_phase sums each variant's kernel runs
    _, chain, total, walls = run_chain_phase(torch, dev, ctx,
                                             names=("stream", "dense"))
    chain["launches"] = path_counts({"gemv", "paged_decode_attention",
                                     "decode_attention"}, "(h2)", total)
    chain["profile_stream"] = profile_chain(torch, ctx, ctx["tables"],
                                            "stream", walls["stream"])
    return chain


def check_time_paged_opt(torch, dev, card_name, heads=OPT_K1_HEADS,
                         dhs=OPT_K1_DH, length=OPT_K1_LEN, what="(h3)"):
    """(h3): kernel 1 at the protocol's shape (B 1, H = G = ``heads`` (32),
    bs 128, T 16, ``length`` (1040) over a table out of order, bf16 pool,
    the fold as decode calls it) for each dh of ``dhs`` (64 and 128):
    against its plain version, then timed beside the plain version and
    the library call (gather + SDPA), with its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import (
        SPLIT, dense_plan, paged_decode_attention)
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    Hq, T_, n = heads, OPT_K1_T, length
    out = {}
    for dh in dhs:
        g = torch.Generator(device=dev).manual_seed(dh)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
        q, kn, vn = rnd(1, Hq, dh), rnd(1, Hq, dh), rnd(1, Hq, dh)
        kp, vp = rnd(T_ + 1, BS, Hq, dh), rnd(T_ + 1, BS, Hq, dh)
        used = -(-n // BS)
        tb = torch.zeros((1, T_), dtype=torch.int32)
        tb[0, :used] = torch.randperm(
            T_, generator=torch.Generator().manual_seed(dh))[:used] + 1
        tb = tb.to(dev)
        ln = torch.tensor([n], dtype=torch.int32, device=dev)
        got = paged_decode_attention(q, kp, vp, tb, ln, k_new=kn, v_new=vn)
        want = paged_decode_attention_ref(q, kp, vp, tb, ln, k_new=kn,
                                          v_new=vn)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL["bfloat16"]
        if not torch.isfinite(got).all() or err > tol:
            raise AssertionError(f"{what} kernel 1 at {Hq} heads, dh {dh}: "
                                 f"vs plain max abs {err} > {tol}")
        n_sets = sets_for(2 * kp.numel() * kp.element_size())
        pools = [(kp.clone(), vp.clone()) for _ in range(n_sets)]
        valid = torch.arange(T_ * BS, device=dev)[None] < ln[:, None]
        mask = torch.cat([valid, torch.ones((1, 1), dtype=torch.bool,
                                            device=dev)], 1)[:, None, None]

        def library(i):
            k = torch.cat([gather_kv_pages(pools[i][0], tb), kn[:, None]], 1)
            v = torch.cat([gather_kv_pages(pools[i][1], tb), vn[:, None]], 1)
            F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2),
                                           v.transpose(1, 2), attn_mask=mask)
        t = timed(torch, {
            "ms": lambda i: paged_decode_attention(
                q, pools[i][0], pools[i][1], tb, ln, k_new=kn, v_new=vn),
            "plain_ms": lambda i: paged_decode_attention_ref(
                q, pools[i][0], pools[i][1], tb, ln, k_new=kn, v_new=vn),
            "library_ms": library}, n_sets)
        # least work: q, the valid K/V rows, the new token, the table and
        # length read once, the output written once; 4 dh flops per head
        # per attended position
        nbytes = 2 * (Hq * dh + 2 * n * Hq * dh + 2 * Hq * dh + Hq * dh) \
            + 4 * (T_ + 1)
        t["bound_ms"], t["bound_by"] = bound_for(
            nbytes, 4 * dh * Hq * (n + 1), "bfloat16", card_name)
        L, stages = dense_plan(T_ * BS, dh, 2)
        t.update(max_abs_err=err, tol=tol, shapes={
            "B": 1, "H": Hq, "G": Hq, "dh": dh, "bs": BS, "T": T_,
            "length": n, "dtype": "bfloat16", "fold": True},
            plan={"grid": [SPLIT, Hq, 1], "blocks": SPLIT * Hq,
                  "tile_rows": L, "stages": stages})
        out[f"dh{dh}"] = t
        del pools
    return out


def check_time_gemv_opt(torch, dev, card_name):
    """(h3): kernel 3 at opt-1.3b's four gemvs with their bias, at 1 and
    4 rows, f32 and bf16: against its plain version, then timed beside it
    and ``torch.addmm`` (``torch.matmul`` where there is no bias)."""
    from repro_torch.kernels.gemv.ops import gemv, gemv_plan
    from repro_torch.kernels.gemv.ref import gemv_ref
    g = torch.Generator(device=dev).manual_seed(21)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        for rows in (1, 4):
            for shape_name, K, N_, bias in OPT_GEMV_SHAPES:
                x = torch.randn((rows, K), generator=g, device=dev).to(dt)
                w = (torch.randn((K, N_), generator=g, device=dev)
                     / math.sqrt(K)).to(dt)
                b = (torch.randn((N_,), generator=g, device=dev)
                     * OPT_BIAS_STD).to(dt) if bias else None
                got = gemv(x, w, b)
                want = gemv_ref(x, w, b)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL[dname]
                if not torch.isfinite(got).all() or err > tol:
                    raise AssertionError(f"(h3) gemv {shape_name} {dname} "
                                         f"B={rows}: max abs {err} > {tol}")
                n_sets = sets_for(w.numel() * w.element_size())
                ws = [w.clone() for _ in range(n_sets)]
                lib = (lambda i: torch.addmm(b, x, ws[i])) if bias else \
                    (lambda i: torch.matmul(x, ws[i]))
                t = timed(torch, {"ms": lambda i: gemv(x, ws[i], b),
                                  "plain_ms": lambda i: gemv_ref(x, ws[i], b),
                                  "library_ms": lib}, n_sets)
                item = x.element_size()
                nbytes = item * (rows * K + K * N_ + rows * N_
                                 + (N_ if bias else 0))
                t["bound_ms"], t["bound_by"] = bound_for(
                    nbytes, 2 * rows * K * N_, dname, card_name)
                ksplit, n_tiles = gemv_plan(K, N_)
                t.update(shape=shape_name, K=K, N=N_, B=rows, dtype=dname,
                         bias=bias, max_abs_err=err, tol=tol, ksplit=ksplit,
                         blocks=ksplit * n_tiles)
                out.append(t)
                del ws
    return out


def weight_bytes(params):
    """Bytes of the weights a decode step reads: every leaf but the
    learned position table, of which it reads one row (the tied
    embedding is read whole, as the head)."""
    pe = params["pos_embed"]
    return sum(t.numel() * t.element_size() for t in _leaves(params)) \
        - pe.numel() * pe.element_size()


def protocol_run(torch, dev, model, params, prompt, out_n, graphs,
                 mesh=None):
    """One engine of the protocol (1 slot, max_seq 2048, 8-step windows,
    a bf16 pool), greedy, on captured windows or (``graphs=False``) the
    eager twin, on one card or as one rank of the ring ``mesh`` (every
    rank calls it alike), warmed by a first request of 16 tokens (which
    captures its prefill, sampler and windows, as a server does once), then
    serving the measured one.  In the middle of its output (KV at the
    mean length) 64 decode steps run under torch.profiler: device ms per
    token from them; wall ms per output token from the engine's own
    clock over the rest of the request, its prefill included.  The
    profiler's count of kernel 1 over those steps beside the launch
    registry's: equal when the profiler sees the kernels inside a
    replay.  Then the time to first token of the same prompt on the
    warmed engine (:func:`time_to_first_token`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    cfg = model.cfg

    eng = LPUEngine(model, params, EngineConfig(
        slots=1, max_seq=OPT_MAX_SEQ, steps_per_sync=OPT_WINDOW,
        kv_dtype="bfloat16"), device=dev, graphs=graphs, mesh=mesh)
    eng.generate([prompt], max_new_tokens=2 * OPT_WINDOW)       # warm
    torch.cuda.synchronize()
    _reset_counts()
    if mesh is not None:
        mesh.reset_counters()
    st = eng.stats
    base = dataclasses.replace(st)
    rid = eng.submit(prompt, out_n)
    mid = PAPER_IN_TOKENS + out_n // 2 - OPT_PROFILE_STEPS // 2
    seq = None
    while seq is None or seq.pos < mid:
        if not eng.sched.has_work():
            raise AssertionError(f"(h4) {cfg.name}: the request ended "
                                 f"before position {mid}")
        eng.step()
        seq = eng.sched.active[0]
    pos0, steps0, wall0 = seq.pos, st.device_decode_steps, st.wall
    k1_0 = _read_counts()["paged_decode_attention"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while st.device_decode_steps - steps0 < OPT_PROFILE_STEPS and \
                eng.sched.has_work():
            eng.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    steps = st.device_decode_steps - steps0
    window_wall = st.wall - wall0
    k1_window = _read_counts()["paged_decode_attention"] - k1_0
    out = eng.drain()[rid]
    torch.cuda.synchronize()
    ring = None if mesh is None else ring_counts(
        mesh, st.device_decode_steps - base.device_decode_steps)
    what = f"(h4) {cfg.name} graphs={graphs}"
    counts = path_counts({"paged_decode_attention"}, what)
    replays = st.graph_replays - base.graph_replays
    if counts["paged_decode_attention"] != cfg.n_layers * (
            st.device_decode_steps - base.device_decode_steps):
        raise AssertionError(f"{what}: launches {counts}")
    if graphs != (replays > 0) or st.graph_captures != base.graph_captures:
        raise AssertionError(f"{what}: {replays} graph replays, "
                             f"{st.graph_captures - base.graph_captures} "
                             "captures while measured")
    pool_checks(eng, what)
    if not all(0 <= t < cfg.vocab_size for t in out):
        raise AssertionError(f"{what}: bad stream")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us or not steps:
        raise AssertionError(f"{what}: the profiler saw {busy_us} us over "
                             f"{steps} decode steps")
    device_ms = busy_us / 1e3 / steps
    # on a ring: the share of it in NCCL's kernels (a kernel waiting for
    # its peers counts its wait)
    nccl_ms = sum(e.self_device_time_total for e in kernels
                  if "nccl" in e.key.lower()) / 1e3 / steps
    # the profiled steps' own wall is left out of the wall per token
    wall_ms = (st.wall - base.wall - window_wall) * 1e3 / (len(out) - steps)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    t_ttft = time.perf_counter()
    ttft = time_to_first_token(torch, eng, prompt)
    ttft["phase_s"] = time.perf_counter() - t_ttft
    return {"out": out, "wall_ms_per_token": wall_ms,
            "device_ms_per_token": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "profiled_window": {
                "decode_steps": steps, "positions": [pos0, pos0 + steps],
                "profiled_wall_ms_per_token": window_s * 1e3 / steps,
                "device_ms_per_token": device_ms,
                "kernel1_profiler_count": sum(
                    e.count for e in kernels
                    if "paged_decode_kernel" in e.key),
                "kernel1_registry_launches": k1_window,
                "nccl_ms_per_token": nccl_ms},
            "total_wall_s": st.wall - base.wall,
            "graph_captures": st.graph_captures, "graph_replays": replays,
            "launches": counts, "ring": ring,
            "ttft": ttft,
            "pool_dtype": str(eng.cache["l0"]["k"].dtype).split(".")[-1],
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def protocol_prompt(cfg):
    """The protocol's seeded prompt of PAPER_IN_TOKENS tokens."""
    import numpy as np
    rng = np.random.RandomState(32)
    return [int(t) for t in rng.randint(1, cfg.vocab_size,
                                        size=PAPER_IN_TOKENS)]


def paper_protocol(torch, dev, name, card_name):
    """(h4): the paper's protocol at batch 1 on ``name`` in bf16 (a plan
    the reference builds too) with a bf16 pool (the ``kv_dtype`` knob:
    the plan's cache dtype is float32, in the reference too): one prompt
    of 32 tokens, greedy, by :func:`protocol_run` on captured windows
    (OPT_OUT[name] new tokens) and on the eager twin (OPT_EAGER_OUT[name]
    new tokens), whose stream must equal the graphs' first tokens.
    Bytes per token are the weights plus the KV at the mean length;
    bandwidth use against the data sheet's.  Measures, does not gate
    (beyond finite, equal, exact-launch runs)."""
    model, params = opt_model(torch, dev, name, "bfloat16")
    cfg, plan = model.cfg, model.plan
    out_n = OPT_OUT[name]
    prompt = protocol_prompt(cfg)
    run = protocol_run(torch, dev, model, params, prompt, out_n, True)
    twin = protocol_run(torch, dev, model, params, prompt,
                        OPT_EAGER_OUT[name], False)
    out, twin_out = run.pop("out"), twin.pop("out")
    if twin_out != out[:len(twin_out)]:
        raise AssertionError(f"(h4) {name}: graph and eager-twin streams "
                             "differ")
    # kernel 1 launches the profiler missed in each twin's 64 steps: its
    # buffers can drop records at full depth, in an eager run too
    missed = [r["profiled_window"]["kernel1_registry_launches"]
              - r["profiled_window"]["kernel1_profiler_count"]
              for r in (run, twin)]
    sees = missed[0] <= max(missed[1], 0)
    if not sees:
        # the profiler missed kernels inside the replays: the device time
        # per token is the eager twin's (no kernel changes between them)
        run["device_ms_per_token"] = twin["device_ms_per_token"]
        run["device_busy_share"] = (run["device_ms_per_token"]
                                    / run["wall_ms_per_token"])
    device_ms, wall_ms = run["device_ms_per_token"], run["wall_ms_per_token"]
    mean_len = PAPER_IN_TOKENS + len(out) / 2
    a = plan.attn
    kv_item = torch.empty((), dtype=getattr(
        torch, run["pool_dtype"])).element_size()
    w_bytes = weight_bytes(params)
    kv_bytes = 2 * cfg.n_layers * a.gp * a.d_head * kv_item * mean_len
    bw = bandwidth_for(card_name)
    per_tok = w_bytes + kv_bytes
    rec = {"arch": name, "dtype": "bfloat16", "batch": 1,
           "in_tokens": PAPER_IN_TOKENS, "out_tokens_asked": out_n,
           "paper_out_tokens": PAPER_OUT_TOKENS,
           "out_tokens": len(out), "max_seq": OPT_MAX_SEQ,
           "steps_per_sync": OPT_WINDOW, **run,
           "profiler_sees_replays": sees,
           "kernel1_missed_by_profiler": {"graphs": missed[0],
                                          "eager_twin": missed[1]},
           "device_ms_source": "graphs" if sees else "eager twin",
           "weight_bytes_per_token": w_bytes,
           "kv_bytes_per_token_at_mean_length": kv_bytes,
           "mean_length": mean_len, "bytes_per_token": per_tok,
           "bound_ms_per_token": per_tok / bw * 1e3,
           "bandwidth_Bps": bw,
           "bandwidth_use_device": per_tok / (device_ms / 1e3) / bw,
           "bandwidth_use_wall": per_tok / (wall_ms / 1e3) / bw,
           "distinct_tokens": len(set(out)),
           "eager_twin": dict(twin, out_tokens=len(twin_out),
                              mean_length=PAPER_IN_TOKENS
                              + len(twin_out) / 2,
                              stream_equals_graphs_prefix=True),
           "card": card_name}
    paper = PAPER.get(name, {})
    if "gpu_slower_x" in paper:
        paper = dict(paper, gpu_ms_per_token=paper["lpu_ms_per_token"]
                     * paper["gpu_slower_x"])
    rec["paper"] = dict(paper, source="benchmarks/paper_constants.py "
                                      "(the paper's figures, not the "
                                      "port's)")
    del model, params
    return rec


def run_opt(torch, dev, card_name, t_start):
    """Phase (h), h1 to h4, each closed by a [time] line."""
    def lap(what, t0):
        print(f"[time] ({what}) {time.perf_counter() - t0:.1f} s, done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    rec = {}
    t0 = time.perf_counter()
    model, params = opt_model(torch, dev, "opt-1.3b")
    rec["h1_engine"] = run_opt_engine(torch, dev, model, params)
    lap("h1 opt-1.3b engine", t0)
    t0 = time.perf_counter()
    rec["h2_chain"] = run_opt_chain(torch, dev, model, params)
    lap("h2 opt-1.3b chain", t0)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["h3_kernel1"] = check_time_paged_opt(torch, dev, card_name)
    rec["h3_gemv"] = check_time_gemv_opt(torch, dev, card_name)
    lap("h3 kernels at OPT shapes", t0)
    t0 = time.perf_counter()
    rec["h4_protocol"] = {}
    for name in OPT_OUT:
        rec["h4_protocol"][name] = paper_protocol(torch, dev, name,
                                                  card_name)
        gc.collect()
        torch.cuda.empty_cache()
    lap("h4 the paper's protocol", t0)
    return rec


# ---------------------------------------------------------------------------
# rwkv6-7b at full width on kernel 4 (the WKV recurrence)
# ---------------------------------------------------------------------------

# kernel 4 against its plain version: the shapes of tests/test_kernels.py
# (:71-72), the engine's decode shape (4 slots, 64 heads x 64) and a
# prefill length
RWKV_DECODE = (4, 1, 64, 64)
RWKV_PREFILL = (1, 512, 64, 64)
RWKV_CHECK_SHAPES = ((1, 16, 1, 8), (2, 64, 2, 16), (2, 32, 4, 32),
                     RWKV_DECODE, RWKV_PREFILL, (1, 5, 1, 64),
                     (1, 3, 1, 32), (2, 3, 3, 100), (1, 4, 2, 128),
                     (4, 1, 64, 128))
# f32 throughout; only the order of the sums differs from the plain version
RWKV_TOL = 1e-4
RWKV_SLOTS, RWKV_REQUESTS, RWKV_NEW = 4, 8, 32
# rwkv6-7b's depth cut to 16 of 32 layers to make room for phase 13
RWKV_DEPTH = 16


def rwkv_inputs(torch, dev, shape, seed):
    """r, k, v, w, u, s0 with the distributions of the reference's kernel
    test, and a nonzero s0."""
    B, S, H, dh = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*sh):
        return torch.randn(sh, generator=g, device=dev)
    w = 0.8 + 0.199 * torch.rand((B, S, H, dh), generator=g, device=dev)
    return (rnd(B, S, H, dh), 0.3 * rnd(B, S, H, dh), rnd(B, S, H, dh), w,
            0.2 * rnd(H, dh), 0.1 * rnd(B, H, dh, dh))


def rwkv_bound(shape, card_name):
    """Least work of one call: r, k, v, w, u and s0 read once, y and the
    final state written once; 7 f32 operations per state element per
    step (the k.v outer product 1, the output 4, the update 2)."""
    B, S, H, dh = shape
    nbytes = 4 * (5 * B * S * H * dh + H * dh + 2 * B * H * dh * dh)
    return bound_for(nbytes, 7 * B * S * H * dh * dh, "float32", card_name)


def check_time_rwkv_scan(torch, dev, card_name):
    """Kernel 4 against its plain version at every listed shape, then
    timed at the decode and the prefill shape beside the plain version;
    at the prefill shape also beside the port's chunked form
    (``wkv_chunked``, the prefill path of ``time_mix_fwd``): no single
    PyTorch call computes the recurrence, so that is the comparator."""
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref
    from repro_torch.models.rwkv import wkv_chunked
    errs, exact = {}, {}
    for i, shape in enumerate(RWKV_CHECK_SHAPES):
        args = rwkv_inputs(torch, dev, shape, seed=10 + i)
        y, s = rwkv_scan(*args)
        yr, sr = rwkv_scan_ref(*args)
        torch.cuda.synchronize()
        err = max((y - yr).abs().max().item(), (s - sr).abs().max().item())
        ok = all(torch.isfinite(t).all() for t in (y, s)) and \
            torch.allclose(y, yr, rtol=RWKV_TOL, atol=RWKV_TOL) and \
            torch.allclose(s, sr, rtol=RWKV_TOL, atol=RWKV_TOL)
        if not ok:
            raise AssertionError(f"rwkv_scan {shape}: kernel vs plain beyond "
                                 f"{RWKV_TOL} (max abs {err})")
        key = "x".join(map(str, shape))
        errs[key] = err
        # the plain version repeats the kernel's order of rounding
        exact[key] = bool(torch.equal(y, yr) and torch.equal(s, sr))
        if not exact[key]:
            raise AssertionError(f"rwkv_scan {shape}: kernel not bit-equal "
                                 f"to its plain version (max abs {err})")
    times = {}
    for name, shape in (("decode", RWKV_DECODE), ("prefill", RWKV_PREFILL)):
        args = rwkv_inputs(torch, dev, shape, seed=20)
        per_set = 4 * sum(a.numel() for a in args)
        sets = [tuple(a.clone() for a in args)
                for _ in range(sets_for(per_set))]
        fns = {"ms": lambda i: rwkv_scan(*sets[i]),
               "plain_ms": lambda i: rwkv_scan_ref(*sets[i])}
        slow = None
        if name == "prefill":
            fns["chunked_ms"] = lambda i: wkv_chunked(*sets[i])
            slow = {"plain_ms": (3, 1), "chunked_ms": (50, 5)}
        t = timed(torch, fns, len(sets), iters=slow)
        t["bound_ms"], t["bound_by"] = rwkv_bound(shape, card_name)
        t["shape"] = list(shape)
        times[name] = t
        del sets
    return errs, exact, times


def rwkv_model(torch, dev):
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.weights import _expected_shapes
    full = get_config("rwkv6-7b")
    cfg = dataclasses.replace(full, n_layers=RWKV_DEPTH)
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    nbytes = 4 * sum(math.prod(s) for s in _expected_shapes(cfg, plan)
                     .values())
    print(f"[rwkv] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers, "
          f"d {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.rwkv.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}: f32 weights {nbytes / 1e9:.2f} GB",
          flush=True)
    model = build_model(cfg, plan, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    got = sum(t.numel() * t.element_size() for t in _leaves(params))
    if got != nbytes:
        raise AssertionError(f"weights hold {got} bytes, reckoned {nbytes}")
    return cfg, model, params, nbytes, time.perf_counter() - t0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def serve_dense(torch, dev, model, params, prompts, max_new, slots=4,
                max_seq=512):
    """The engine on the dense per-slot cache (a recurrent family's
    default), greedy; -> (streams, engine)."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    eng = LPUEngine(model, params, EngineConfig(slots=slots,
                                                max_seq=max_seq), device=dev)
    outs = eng.generate(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    on_graphs(eng)
    return outs, eng


def rwkv_replay(torch, dev, model, params, prompts, outs, use_kernels):
    """Teacher-forced replay of the engine's streams, all rows in one
    batch (an rwkv state has no positions): each prompt prefilled at its
    exact length into its row, then the stream's tokens fed one decode
    step at a time.  -> (logits (new, rows, V_pad), prefill launches,
    decode launches, decode ms per step)."""
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    from repro_torch.serving.kv_cache import scatter_prefill_dense
    n = len(prompts)
    cache = model.init_cache(n, 1)
    rows = []
    rwkv_scan.launches = 0
    for b, p in enumerate(prompts):
        logits, pc = model.forward(
            params, torch.tensor([p], device=dev), mode="prefill",
            cache=model.init_cache(1, len(p)))
        rows.append(logits[0, -1])
        scatter_prefill_dense(cache, pc, b)
    first = [torch.stack(rows)]
    prefill_launches = rwkv_scan.launches
    toks = torch.tensor(outs, device=dev).t()            # (new, rows)
    pos = torch.zeros((n,), dtype=torch.int32, device=dev)
    rwkv_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(toks.shape[0] - 1):
        logits, _ = model.forward(params, toks[t][:, None], mode="decode",
                                  positions=pos, cache=cache,
                                  use_kernels=use_kernels)
        first.append(logits[:, -1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (toks.shape[0] - 1) * 1e3
    return torch.stack(first), prefill_launches, rwkv_scan.launches, ms


def profile_serve(torch, dev, model, params, prompts, max_new, wall_s,
                  kernel, **serve_kw):
    """Device time by kernel over the same engine run (``serve_dense``
    with ``serve_kw``) under torch.profiler; busy share against the
    unprofiled run's wall; the time and launches of the kernels whose
    name holds ``kernel``."""
    kernels = device_kernels(lambda: serve_dense(
        torch, dev, model, params, prompts, max_new, **serve_kw))
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    mine = [e for e in kernels if kernel in e.key]
    return {"device_busy_ms": busy_us / 1e3,
            "unprofiled_wall_ms": wall_s * 1e3,
            "device_busy_share": busy_us / 1e6 / wall_s,
            f"{kernel}_ms": sum(e.self_device_time_total
                                for e in mine) / 1e3,
            f"{kernel}_launches": sum(e.count for e in mine),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def run_rwkv(torch, dev):
    """Full-width rwkv6-7b (f32, random weights from seed 0) served by
    ``LPUEngine``: 8 prompts of 2-64 tokens x 32 new tokens, 4 slots,
    greedy.  Kernel 4 must launch exactly once per layer per device
    decode step and never in prefill; the streams are replayed
    teacher-forced with the kernel and with its plain version (the
    oracle): logits within RWKV_TOL, and the engine's tokens equal the
    oracle's argmax wherever its top-2 gap exceeds RWKV_TOL."""
    import numpy as np
    cfg, model, params, nbytes, init_s = rwkv_model(torch, dev)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                            size=rng.randint(2, 65))]
               for _ in range(RWKV_REQUESTS)]
    serve_dense(torch, dev, model, params, prompts[:2], 4,
                RWKV_SLOTS)                                   # warm-up
    _reset_counts()
    outs, eng = serve_dense(torch, dev, model, params, prompts, RWKV_NEW,
                            RWKV_SLOTS)
    counts = _read_counts()
    st = eng.stats
    want = {name: 0 for name in counts}
    want["rwkv_scan"] = cfg.n_layers * st.device_decode_steps
    if st.device_decode_steps == 0 or counts != want:
        raise AssertionError(f"rwkv engine launches {counts}, expected "
                             f"{want} ({cfg.n_layers} per device decode "
                             "step, none in prefill)")
    if st.graph_replays == 0:
        raise AssertionError("the rwkv engine replayed no captured window")
    for o in outs:
        if len(o) != RWKV_NEW or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"bad rwkv stream {o}")
    profile = profile_serve(torch, dev, model, params, prompts, RWKV_NEW,
                            st.wall, "wkv_kernel", slots=RWKV_SLOTS)

    got, pre_k, dec_k, ms_k = rwkv_replay(torch, dev, model, params, prompts,
                                          outs, True)
    ref, pre_p, dec_p, ms_p = rwkv_replay(torch, dev, model, params, prompts,
                                          outs, False)
    steps = RWKV_NEW - 1
    if pre_k or pre_p or dec_p or dec_k != cfg.n_layers * steps:
        raise AssertionError(f"replay launches: prefill {pre_k}/{pre_p}, "
                             f"decode {dec_k} (want {cfg.n_layers * steps})"
                             f"/{dec_p} (want 0)")
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        raise AssertionError("rwkv replay: non-finite logits")
    err = (got - ref).abs().max().item()
    if err > RWKV_TOL:
        raise AssertionError(f"rwkv replay: kernel vs plain max abs {err} "
                             f"> {RWKV_TOL}")
    # the model's own f32 noise floor at full depth, for the record: the
    # same plain replay in two batches of 4 rows, where cuBLAS picks other
    # f32 product kernels; the kernel and its plain version round alike
    # (bit for bit), so the replay check above holds below this floor
    halves = torch.cat([rwkv_replay(torch, dev, model, params, prompts[:4],
                                    outs[:4], False)[0],
                        rwkv_replay(torch, dev, model, params, prompts[4:],
                                    outs[4:], False)[0]], 1)
    floor_by_step = (halves - ref).abs().amax(dim=(1, 2)).tolist()
    gap = top2_gap(ref)
    decided = gap > RWKV_TOL
    toks = torch.tensor(outs, device=dev).t()
    ref_arg = ref.argmax(-1)
    if not torch.equal(toks[decided], ref_arg[decided]) or \
            not torch.equal(got.argmax(-1)[decided], ref_arg[decided]):
        raise AssertionError("rwkv: greedy tokens differ from the plain "
                             "oracle's argmax where its top-2 gap exceeds "
                             f"{RWKV_TOL}")

    # the model's decode step at the engine's batch, on its own
    cache = model.init_cache(RWKV_SLOTS, 1)
    tok = torch.ones((RWKV_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.zeros((RWKV_SLOTS,), dtype=torch.int32, device=dev)
    model.forward(params, tok, mode="decode", positions=pos, cache=cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        model.forward(params, tok, mode="decode", positions=pos, cache=cache)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 16 * 1e3
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "head_dim": cfg.rwkv.head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "dtype": "float32",
            "weight_bytes": nbytes, "init_s": init_s,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "slots": RWKV_SLOTS, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "max_new": RWKV_NEW,
            "tokens": st.tokens, "tokens_per_s": st.tokens_per_s,
            "wall_s": st.wall, "decode_steps": st.steps,
            "device_decode_steps": st.device_decode_steps,
            "prefills": st.prefills, "state_bytes": eng.kv_cache_bytes(),
            "graph_captures": st.graph_captures,
            "graph_replays": st.graph_replays,
            "launches": counts,
            "launches_per_device_decode_step":
                counts["rwkv_scan"] / st.device_decode_steps,
            "decode_step_ms_b4": step_ms,
            "replay": {"rows": len(prompts), "steps": steps,
                       "kernel_ms_per_step": ms_k,
                       "plain_ms_per_step": ms_p,
                       "decode_launches_kernel": dec_k,
                       "max_abs_err_vs_plain": err, "tol": RWKV_TOL,
                       "bit_equal": bool(torch.equal(got, ref)),
                       "plain_b8_vs_2xb4_max_abs": max(floor_by_step),
                       "plain_b8_vs_2xb4_by_step": floor_by_step,
                       "argmax_checked": int(decided.sum()),
                       "argmax_total": int(decided.numel()),
                       "ref_logit_std": ref.std().item(),
                       "ref_top2_gap_min": gap.min().item()},
            "profile": profile}


# kernel 5 against its plain version: the shapes of tests/test_kernels.py
# (:56-57), the jamba engine's decode shape (4 slots, d_inner 8192,
# d_state 16), its longest prefill (64 tokens) and a longer prefill
MAMBA_DECODE = (4, 1, 8192, 16)
MAMBA_PREFILL = (1, 64, 8192, 16)
MAMBA_LONG = (1, 512, 8192, 16)
MAMBA_CHECK_SHAPES = ((1, 32, 8, 8), (2, 128, 16, 16), (2, 64, 32, 8),
                      MAMBA_DECODE, MAMBA_PREFILL, MAMBA_LONG)
# f32 throughout; the plain version repeats the kernel's rounding order
MAMBA_TOL = 1e-4
# jamba-v0.1-52b at full width, cut from 32 layers to one super-block of
# 8 (52B parameters do not fit one 80 GB card, even in bf16; depth 8 is
# 13.3e9 parameters, 53 GB in f32)
JAMBA_DEPTH = 8
JAMBA_SLOTS, JAMBA_REQUESTS, JAMBA_NEW, JAMBA_MAX_SEQ = 4, 8, 32, 512
JAMBA_TOL = 1e-4


def mamba_inputs(torch, dev, shape, seed):
    """da, bx, c, h0 with the distributions of the reference's kernel
    test (da in [0.5, 0.99)), and a nonzero h0."""
    B, S, C, N = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return (0.5 + 0.49 * torch.rand((B, S, C, N), generator=g, device=dev),
            0.1 * torch.randn((B, S, C, N), generator=g, device=dev),
            torch.randn((B, S, N), generator=g, device=dev),
            0.1 * torch.randn((B, C, N), generator=g, device=dev))


def mamba_fused_inputs(torch, dev, shape, seed):
    """dt (softplus of a normal, shifted as jamba's dt_bias leaves it), x,
    a = -exp(a_log) with jamba's a_log = log(1..N) plus noise, b, c and a
    nonzero h0."""
    B, S, C, N = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, C), generator=g, device=dev) - 2.0)
    a = -torch.exp(torch.log(torch.arange(1, N + 1, device=dev).float())
                   + 0.1 * torch.randn((C, N), generator=g, device=dev))
    return (dt, torch.randn((B, S, C), generator=g, device=dev), a,
            torch.randn((B, S, N), generator=g, device=dev),
            torch.randn((B, S, N), generator=g, device=dev),
            0.1 * torch.randn((B, C, N), generator=g, device=dev))


def mamba_bound(shape, card_name):
    """Least work of one call: da, bx, c and h0 read once, y and the
    final state written once; 4 f32 operations per (b, t, c, n) element
    (the update's product and sum, the output's product and sum)."""
    B, S, C, N = shape
    nbytes = 4 * (2 * B * S * C * N + B * S * N + 2 * B * C * N + B * S * C)
    return bound_for(nbytes, 4 * B * S * C * N, "float32", card_name)


# the SFUs' exp2 rate: 16 a clock per SM (NVIDIA's CUDA programming
# guide, compute capability 9.0) x 132 SMs x the H100 SXM's 1.98 GHz boost
SFU_PER_S = 16 * 132 * 1.98e9


def mamba_fused_bound(shape, card_name):
    """Least work of one fused call: dt, x, a, b, c and h0 read once, y
    and the final state written once; per (b, t, c, n) element one
    exponential on the SFUs and 6 f32 operations (dt*a, (dt*x)*b, the
    update's product and sum, the output's product and sum).  The larger
    of the bytes' time and the exponentials' time on the SFUs (the f32
    operations take less than either)."""
    B, S, C, N = shape
    nbytes = 4 * (3 * B * S * C + C * N + 2 * B * S * N + 2 * B * C * N)
    t_bytes, _ = bound_for(nbytes, 0, "float32", card_name)
    elems = B * S * C * N
    t_ops = max(elems / SFU_PER_S, 6 * elems / PEAK_OPS["float32"]) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def mamba_producers(torch, dt, x, a, b):
    """The jamba layer's PyTorch producers of da and bx, as
    ``models/mamba.py`` ran them before the fused entry: the
    comparator's first half."""
    da = torch.exp(dt[..., None] * a)
    bx = (dt * x)[..., None] * b[:, :, None, :]
    return da.contiguous(), bx.contiguous()


def check_mamba_entry(torch, entry, kernel, plain, inputs, errs, exact):
    """One entry of kernel 5 against its plain version at every listed
    shape: finite, within MAMBA_TOL, and whether bit-equal."""
    for i, shape in enumerate(MAMBA_CHECK_SHAPES):
        args = inputs(shape, 30 + i)
        y, h = kernel(*args)
        yr, hr = plain(*args)
        torch.cuda.synchronize()
        err = max((y - yr).abs().max().item(), (h - hr).abs().max().item())
        ok = all(torch.isfinite(t).all() for t in (y, h)) and \
            torch.allclose(y, yr, rtol=MAMBA_TOL, atol=MAMBA_TOL) and \
            torch.allclose(h, hr, rtol=MAMBA_TOL, atol=MAMBA_TOL)
        if not ok:
            raise AssertionError(f"{entry} {shape}: kernel vs plain "
                                 f"beyond {MAMBA_TOL} (max abs {err})")
        key = "x".join(map(str, shape))
        errs[key] = err
        exact[key] = bool(torch.equal(y, yr) and torch.equal(h, hr))
        del args, y, h, yr, hr


def check_time_mamba_scan(torch, dev, card_name):
    """Kernel 5's two entries against their plain versions at every
    listed shape, then timed at the decode, the engine's longest prefill
    and a 512-token prefill: entry (a) beside its plain version, entry
    (b) (fused) beside its plain version and the path it replaced, the
    PyTorch producers of da and bx followed by entry (a).  No single
    PyTorch call computes the recurrence, so there is no library time.
    -> ({entry: {shape: err}}, {entry: {shape: bit-equal}}, times)."""
    from repro_torch.kernels.mamba_scan.ops import (mamba_plan, mamba_scan,
                                                    mamba_scan_fused)
    from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                    mamba_scan_ref)
    errs, exact = {"a": {}, "fused": {}}, {"a": {}, "fused": {}}
    check_mamba_entry(torch, "mamba_scan", mamba_scan, mamba_scan_ref,
                      lambda sh, sd: mamba_inputs(torch, dev, sh, sd),
                      errs["a"], exact["a"])
    check_mamba_entry(torch, "mamba_scan_fused", mamba_scan_fused,
                      mamba_scan_fused_ref,
                      lambda sh, sd: mamba_fused_inputs(torch, dev, sh, sd),
                      errs["fused"], exact["fused"])
    times = {}
    for name, shape, slow in (("decode", MAMBA_DECODE, None),
                              ("prefill64", MAMBA_PREFILL, (20, 2)),
                              ("prefill512", MAMBA_LONG, (3, 1))):
        args = mamba_inputs(torch, dev, shape, seed=40)
        per_set = 4 * sum(a.numel() for a in args)
        sets = [tuple(a.clone() for a in args)
                for _ in range(sets_for(per_set))]
        del args
        fns = {"ms": lambda i: mamba_scan(*sets[i]),
               "plain_ms": lambda i: mamba_scan_ref(*sets[i])}
        t = timed(torch, fns, len(sets),
                  iters={"plain_ms": slow} if slow else None)
        t["bound_ms"], t["bound_by"] = mamba_bound(shape, card_name)
        del sets, fns
        torch.cuda.empty_cache()
        args = mamba_fused_inputs(torch, dev, shape, seed=41)
        per_set = 4 * sum(a.numel() for a in args)
        fsets = [tuple(a.clone() for a in args)
                 for _ in range(sets_for(per_set))]
        del args

        def old_path(i):
            dt, x, a, b, c, h0 = fsets[i]
            return mamba_scan(*mamba_producers(torch, dt, x, a, b), c, h0)
        ft = timed(torch, {"ms": lambda i: mamba_scan_fused(*fsets[i]),
                           "plain_ms":
                               lambda i: mamba_scan_fused_ref(*fsets[i]),
                           "old_path_ms": old_path}, len(fsets),
                   iters={"plain_ms": slow} if slow else None)
        t.update({("" if k.startswith("old_path") else "fused_") + k: v
                  for k, v in ft.items()})
        t["fused_bound_ms"], t["fused_bound_by"] = mamba_fused_bound(
            shape, card_name)
        t["shape"] = list(shape)
        t["plan_a"] = mamba_plan(*shape, fused=False)
        t["plan_fused"] = mamba_plan(*shape, fused=True)
        times[name] = t
        del fsets
        torch.cuda.empty_cache()
    return errs, exact, times


def jamba_schedule(cfg):
    return ["/".join(("attn" if cfg.is_attention_layer(j) else "mamba",
                      "moe" if cfg.is_moe_layer(j) else "mlp"))
            for j in range(cfg.n_layers)]


def jamba_model(torch, dev):
    import dataclasses
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.weights import _expected_shapes
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_DEPTH)
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    nbytes = 4 * sum(math.prod(s) for s in _expected_shapes(cfg, plan)
                     .values())
    print(f"[jamba] {cfg.name}: depth cut from {full.n_layers} to "
          f"{cfg.n_layers} layers (one super-block; the card's memory), "
          f"full width: d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads x {cfg.d_head}, d_inner {cfg.mamba.expand * cfg.d_model}, "
          f"d_state {cfg.mamba.d_state}, dt_rank {cfg.mamba.dt_rank}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} x "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab_size}; schedule "
          f"{jamba_schedule(cfg)}; f32 weights {nbytes / 1e9:.2f} GB",
          flush=True)
    model = build_model(cfg, plan, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    got = sum(t.numel() * t.element_size() for t in _leaves(params))
    if got != nbytes:
        raise AssertionError(f"weights hold {got} bytes, reckoned {nbytes}")
    return cfg, model, params, nbytes, time.perf_counter() - t0


def jamba_replay(torch, dev, model, params, prompts, outs, use_kernels):
    """Teacher-forced replay of the engine's streams in the engine's own
    batching: the 8 requests ran as two batches of 4 slots (all streams
    have the same length, so a batch finishes together and the next is
    admitted into the same slots), so each batch of 4 rows gets a dense
    cache of the engine's shape; each prompt is prefilled at its exact
    length into its row, then the stream's tokens are fed one decode step
    at a time at their positions.  -> (logits (new, rows, V_pad), prefill
    launches, decode launches, decode ms per step)."""
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
    from repro_torch.serving.kv_cache import scatter_prefill_dense
    out, pre_l, dec_l, dec_s, steps = [], 0, 0, 0.0, 0
    for lo in range(0, len(prompts), JAMBA_SLOTS):
        ps, os_ = prompts[lo:lo + JAMBA_SLOTS], outs[lo:lo + JAMBA_SLOTS]
        cache = model.init_cache(len(ps), JAMBA_MAX_SEQ)
        rows = []
        mamba_scan_fused.launches = 0
        for b, p in enumerate(ps):
            logits, pc = model.forward(
                params, torch.tensor([p], device=dev), mode="prefill",
                cache=model.init_cache(1, len(p)), use_kernels=use_kernels)
            rows.append(logits[0, -1])
            scatter_prefill_dense(cache, pc, b)
        pre_l += mamba_scan_fused.launches
        got = [torch.stack(rows)]
        toks = torch.tensor(os_, device=dev).t()          # (new, rows)
        pos = torch.tensor([len(p) for p in ps], dtype=torch.int32,
                           device=dev)
        mamba_scan_fused.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(toks.shape[0] - 1):
            logits, _ = model.forward(params, toks[t][:, None],
                                      mode="decode", positions=pos + t,
                                      cache=cache, use_kernels=use_kernels)
            got.append(logits[:, -1])
        torch.cuda.synchronize()
        dec_s += time.perf_counter() - t0
        steps += toks.shape[0] - 1
        dec_l += mamba_scan_fused.launches
        out.append(torch.stack(got))
        del cache
    return torch.cat(out, 1), pre_l, dec_l, dec_s / steps * 1e3


def run_jamba(torch, dev):
    """Full-width jamba-v0.1-52b at depth 8 (f32, random weights from
    seed 0) served by ``LPUEngine``: 8 prompts of 2-64 tokens x 32 new
    tokens, 4 slots, greedy, dense cache.  Kernel 5's fused entry must
    launch exactly once per mamba layer (7) per device decode step and
    per prefill, and no other kernel (nor entry (a)) may launch; the
    streams are replayed teacher-forced with the kernel and with its
    plain version (the oracle): logits within JAMBA_TOL, and the engine's
    tokens equal the oracle's argmax wherever its top-2 gap exceeds
    JAMBA_TOL."""
    import numpy as np
    cfg, model, params, nbytes, init_s = jamba_model(torch, dev)
    peak_init = torch.cuda.max_memory_allocated()
    print(f"[jamba] weights on the card: {nbytes} bytes, init "
          f"{init_s:.1f} s, peak device memory {peak_init / 1e9:.2f} GB",
          flush=True)
    n_mamba = sum(not cfg.is_attention_layer(i) for i in range(cfg.n_layers))
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                            size=rng.randint(2, 65))]
               for _ in range(JAMBA_REQUESTS)]
    serve_dense(torch, dev, model, params, prompts[:2], 4, JAMBA_SLOTS,
                JAMBA_MAX_SEQ)                                # warm-up
    _reset_counts()
    outs, eng = serve_dense(torch, dev, model, params, prompts, JAMBA_NEW,
                            JAMBA_SLOTS, JAMBA_MAX_SEQ)
    counts = _read_counts()
    st = eng.stats
    want = {name: 0 for name in counts}
    want["mamba_scan_fused"] = n_mamba * (st.device_decode_steps
                                          + st.prefills)
    if st.device_decode_steps == 0 or st.prefills != len(prompts) or \
            counts != want:
        raise AssertionError(
            f"jamba engine launches {counts}, expected {want} ({n_mamba} per "
            f"device decode step and per prefill; {st.prefills} prefills)")
    if st.graph_replays == 0:
        raise AssertionError("the jamba engine replayed no captured window")
    for o in outs:
        if len(o) != JAMBA_NEW or not all(0 <= t < cfg.vocab_size
                                          for t in o):
            raise AssertionError(f"bad jamba stream {o}")
    profile = profile_serve(torch, dev, model, params, prompts, JAMBA_NEW,
                            st.wall, "scan_kernel", slots=JAMBA_SLOTS,
                            max_seq=JAMBA_MAX_SEQ)

    torch.backends.cuda.matmul.allow_tf32 = False     # as the engine sets
    torch.backends.cudnn.allow_tf32 = False
    got, pre_k, dec_k, ms_k = jamba_replay(torch, dev, model, params,
                                           prompts, outs, True)
    ref, pre_p, dec_p, ms_p = jamba_replay(torch, dev, model, params,
                                           prompts, outs, False)
    steps = JAMBA_NEW - 1
    want_dec = n_mamba * steps * math.ceil(len(prompts) / JAMBA_SLOTS)
    if pre_p or dec_p or pre_k != n_mamba * len(prompts) or \
            dec_k != want_dec:
        raise AssertionError(
            f"replay launches: prefill {pre_k} (want "
            f"{n_mamba * len(prompts)})/{pre_p} (want 0), decode {dec_k} "
            f"(want {want_dec})/{dec_p} (want 0)")
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        raise AssertionError("jamba replay: non-finite logits")
    err = (got - ref).abs().max().item()
    if err > JAMBA_TOL:
        raise AssertionError(f"jamba replay: kernel vs plain max abs {err} "
                             f"> {JAMBA_TOL}")
    gap = top2_gap(ref)
    decided = gap > JAMBA_TOL
    toks = torch.tensor(outs, device=dev).t()
    ref_arg = ref.argmax(-1)
    if not torch.equal(toks[decided], ref_arg[decided]) or \
            not torch.equal(got.argmax(-1)[decided], ref_arg[decided]):
        raise AssertionError("jamba: greedy tokens differ from the plain "
                             "oracle's argmax where its top-2 gap exceeds "
                             f"{JAMBA_TOL}")

    # the model's decode step at the engine's batch, on its own
    cache = model.init_cache(JAMBA_SLOTS, JAMBA_MAX_SEQ)
    tok = torch.ones((JAMBA_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((JAMBA_SLOTS,), 64, dtype=torch.int32, device=dev)
    model.forward(params, tok, mode="decode", positions=pos, cache=cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        model.forward(params, tok, mode="decode", positions=pos, cache=cache)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "n_layers_published": 32, "schedule": jamba_schedule(cfg),
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "d_inner":
                cfg.mamba.expand * cfg.d_model, "d_state": cfg.mamba.d_state,
            "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
            "d_ff_expert": cfg.moe.d_ff_expert, "vocab": cfg.vocab_size,
            "dtype": "float32", "weight_bytes": nbytes, "init_s": init_s,
            "peak_memory_after_init_bytes": peak_init,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "slots": JAMBA_SLOTS, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "max_new": JAMBA_NEW,
            "tokens": st.tokens, "tokens_per_s": st.tokens_per_s,
            "wall_s": st.wall, "decode_steps": st.steps,
            "device_decode_steps": st.device_decode_steps,
            "prefills": st.prefills, "cache_bytes": eng.kv_cache_bytes(),
            "kv_bytes_moved_per_step": eng.kv_bytes_moved_per_step(),
            "graph_captures": st.graph_captures,
            "graph_replays": st.graph_replays,
            "launches": counts,
            "mamba_scan_per_device_decode_step_and_prefill": n_mamba,
            "decode_step_ms_b4": step_ms,
            "replay": {"rows": len(prompts), "batches_of": JAMBA_SLOTS,
                       "steps": steps,
                       "kernel_ms_per_step": ms_k,
                       "plain_ms_per_step": ms_p,
                       "prefill_launches_kernel": pre_k,
                       "decode_launches_kernel": dec_k,
                       "max_abs_err_vs_plain": err, "tol": JAMBA_TOL,
                       "bit_equal": bool(torch.equal(got, ref)),
                       "engine_tokens_equal_kernel_argmax": bool(
                           torch.equal(toks, got.argmax(-1))),
                       "argmax_checked": int(decided.sum()),
                       "argmax_total": int(decided.numel()),
                       "ref_logit_std": ref.std().item(),
                       "ref_top2_gap_min": gap.min().item()},
            "profile": profile}


# ---------------------------------------------------------------------------
# 11. the remaining families: granite-moe-3b at full width (depth cut to
# 8 of 32) through the engine,
# llama4-maverick (its shared expert) and
# llava-next-34b at a cut depth through the engine, llava's patch
# projector and whisper-tiny's encoder-decoder through the serving steps
# ---------------------------------------------------------------------------

# kernel 1 at the GQA shapes these families give it: (family, query
# heads, kv heads, dh, the engine's pool dtype); group sizes 3, 5, 7
FAMILY_K1 = (("granite", 24, 8, 64, "float32"),
             ("llama4", 40, 8, 128, "bfloat16"),
             ("llava", 56, 8, 128, "bfloat16"))
# the engine cell's traffic: 8 prompts of 2-64 tokens x 32 new on 4
# slots, max_seq 512, blocks of 128; the bf16 models 4 prompts x 16 new
FAMILY_SLOTS, FAMILY_MAX_SEQ = 4, 512
GRANITE_REQUESTS, GRANITE_NEW = 8, 32
BF16_REQUESTS, BF16_NEW = 4, 16
# depth cuts: one super-block of llama4 (a dense layer and an MoE layer;
# one MoE layer's 128 experts are 16.1e9 parameters), 8 of llava's 60,
# 16 of granite's 32 (its eager twin's expert loop was the run's longest
# lap, ~45 s at full depth: the cut makes room for phase 13)
LLAMA4_DEPTH, LLAVA_DEPTH, GRANITE_DEPTH = 2, 8, 16
# llava through the steps: 2880 patches + 16 text tokens, 16 serve steps
LLAVA_TEXT, LLAVA_STEPS = 16, 16
# whisper through the steps: 4 rows of (1500, 384) frames, 4-token
# prompts, 32 serve steps
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_STEPS = 4, 4, 32
FAMILY_REPLAYS = 20


@contextlib.contextmanager
def capture_clock(torch):
    """{program kind: seconds} spent building programs (the eager warm-up
    and the capture) inside the block: ``Programs.get`` timed at its
    first use of a key, the card synchronised around it."""
    from repro_torch.serving.graphs import Programs
    get = Programs.get
    spent = {}

    def timed_get(self, key, fn, **kw):
        if key in self._by_key:
            return get(self, key, fn, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog = get(self, key, fn, **kw)
        torch.cuda.synchronize()
        spent[key[0]] = spent.get(key[0], 0.0) + time.perf_counter() - t0
        return prog
    Programs.get = timed_get
    try:
        yield spent
    finally:
        Programs.get = get


def check_time_family_k1(torch, dev, card_name):
    """Kernel 1 at each family's GQA shape: at its split's edges on the
    engine's pool dtype and on an int8 pool (:func:`check_paged_split`),
    then at the engine's decode shape (4 rows of lengths LENGTHS over
    tables of 4 blocks of 128, the fold) against its plain version, timed
    beside it, the library call (gather + SDPA with GQA) and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    out = {}
    for fam, hq, gk, dh, pool in FAMILY_K1:
        split = check_paged_split(torch, dev, heads=(hq, gk, dh),
                                  pools=(pool, "int8"))
        dt = getattr(torch, pool)
        g = torch.Generator(device=dev).manual_seed(hq)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        q, kn, vn = rnd(B, hq, dh), rnd(B, gk, dh), rnd(B, gk, dh)
        kp, vp = rnd(N, BS, gk, dh), rnd(N, BS, gk, dh)
        tb = torch.zeros((B, T), dtype=torch.int32)
        for b, n in enumerate(LENGTHS):
            used = -(-n // BS)
            tb[b, :used] = torch.arange(1 + T * b, 1 + T * b + used)
        tb = tb.to(dev)
        ln = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
        got = paged_decode_attention(q, kp, vp, tb, ln, k_new=kn, v_new=vn)
        want = paged_decode_attention_ref(q, kp, vp, tb, ln, k_new=kn,
                                          v_new=vn)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[pool]
        if not torch.isfinite(got).all() or err > tol:
            raise AssertionError(f"(11) kernel 1 at {fam}'s shape: vs plain "
                                 f"max abs {err} > {tol}")
        n_sets = sets_for(2 * kp.numel() * kp.element_size())
        pools = [(kp.clone(), vp.clone()) for _ in range(n_sets)]
        valid = torch.arange(T * BS, device=dev)[None] < ln[:, None]
        mask = torch.cat([valid, torch.ones((B, 1), dtype=torch.bool,
                                            device=dev)], 1)[:, None, None]

        def library(i):
            k = torch.cat([gather_kv_pages(pools[i][0], tb), kn[:, None]], 1)
            v = torch.cat([gather_kv_pages(pools[i][1], tb), vn[:, None]], 1)
            F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        t = timed(torch, {
            "ms": lambda i: paged_decode_attention(
                q, pools[i][0], pools[i][1], tb, ln, k_new=kn, v_new=vn),
            "plain_ms": lambda i: paged_decode_attention_ref(
                q, pools[i][0], pools[i][1], tb, ln, k_new=kn, v_new=vn),
            "library_ms": library}, n_sets)
        # least work: q, the valid K/V rows, the new token, tables and
        # lengths read once, the output written once; 4 dh flops per q
        # head per attended position
        item = kp.element_size()
        rows = sum(LENGTHS)
        nbytes = item * (2 * B * hq * dh + 2 * rows * gk * dh
                         + 2 * B * gk * dh) + 4 * (B * T + B)
        t["bound_ms"], t["bound_by"] = bound_for(
            nbytes, 4 * dh * hq * (rows + B), pool, card_name)
        t.update(max_abs_err=err, tol=tol, split_edges=split, shapes={
            "B": B, "H": hq, "G": gk, "gs": hq // gk, "dh": dh, "bs": BS,
            "T": T, "lengths": list(LENGTHS), "dtype": pool, "fold": True})
        out[fam] = t
        del pools
    return out


def family_model(torch, dev, name, dtype, depth=None):
    """(model, params, record) of ``name`` at full width (its depth cut
    to ``depth`` layers when given) in ``dtype``, random weights drawn
    on the card from seed 0 by the port's generator."""
    import dataclasses
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.weights import _expected_shapes
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=depth) if depth else full
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype=dtype, param_dtype=dtype)
    n_params = sum(math.prod(s) for s in _expected_shapes(cfg, plan)
                   .values())
    model = build_model(cfg, plan, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    if nbytes != n_params * torch.empty((), dtype=getattr(
            torch, dtype)).element_size():
        raise AssertionError(f"{name}: weights hold {nbytes} bytes for "
                             f"{n_params} parameters")
    rec = {"arch": name, "family": cfg.family, "n_layers": cfg.n_layers,
           "n_layers_published": full.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "d_head": cfg.d_head, "vocab": cfg.vocab_size, "dtype": dtype,
           "params": n_params, "weight_bytes": nbytes, "init_s": init_s,
           "peak_memory_after_init_bytes": torch.cuda.max_memory_allocated()}
    if cfg.moe is not None:
        rec.update(experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                   d_ff_expert=cfg.moe.d_ff_expert,
                   moe_every=cfg.moe.moe_every,
                   shared_experts=cfg.moe.n_shared_experts)
    print(f"[families] {name}: {cfg.n_layers} of {full.n_layers} layers, "
          f"d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.d_head}, {n_params / 1e9:.3f}e9 parameters, {dtype} "
          f"weights {nbytes / 1e9:.2f} GB, init {init_s:.1f} s",
          flush=True)
    return model, params, rec


def family_prompts(cfg, n, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                         size=rng.randint(2, 65))]
            for _ in range(n)]


def window_step(torch, eng):
    """One decode step on graphs: the engine's captured 1-step window
    replayed alone after its run drained, over its static buffers (idle
    rows' writes land in the null block; the launch registry is not
    touched): device ms per step by CUDA events over FAMILY_REPLAYS back
    to back replays, and two replays' kernels (count, kernel 1's time,
    the products': cuBLAS's kernels and their split-K reductions) under
    torch.profiler."""
    g = eng._programs._by_key[("window", 1, False)].graph
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FAMILY_REPLAYS):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    reps = 2

    def run():
        for _ in range(reps):
            g.replay()
        torch.cuda.synchronize()
    kernels = device_kernels(run)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    k1 = [e for e in kernels if "paged_decode_kernel" in e.key]
    gemm = [e for e in kernels if any(w in e.key.lower() for w in
                                      ("gemm", "gemv", "cutlass", "sm90_",
                                       "nvjet", "xmma", "splitk"))]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"device_ms_per_step": start.elapsed_time(stop) / FAMILY_REPLAYS,
            "profiled_device_busy_ms_per_step": busy,
            "kernels_per_step": sum(e.count for e in kernels) / reps,
            "kernel1_per_step": sum(e.count for e in k1) / reps,
            "kernel1_ms_per_step": sum(e.self_device_time_total
                                       for e in k1) / 1e3 / reps,
            "products_ms_per_step": sum(e.self_device_time_total
                                        for e in gemm) / 1e3 / reps,
            "top_kernels": [{"name": e.key[:80], "count": e.count / reps,
                             "ms": e.self_device_time_total / 1e3 / reps}
                            for e in top]}


def expert_loop(torch, dev, model, params, rows):
    """The device time of the decode step's MoE layers alone: every MoE
    layer's ``moe_fwd`` (the expert loop over every expert, as the
    reference's single-device path) at ``rows`` tokens, run eagerly
    under torch.profiler: busy ms and kernels."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import (layer_params,
                                                n_super_blocks,
                                                super_block_size)
    cfg, plan = model.cfg, model.plan
    moes = [layer_params(params, i)[f"l{j}"]["moe"]
            for i in range(n_super_blocks(cfg))
            for j in range(super_block_size(cfg)) if cfg.is_moe_layer(j)]
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((rows, 1, cfg.d_model), generator=g, device=dev).to(
        moes[0]["router"].dtype)

    def run():
        for p in moes:
            moe_mod.moe_fwd(p, x, cfg=cfg, plan=plan)
        torch.cuda.synchronize()
    run()
    kernels = device_kernels(run)
    return {"moe_layers": len(moes), "rows": rows,
            "device_ms": sum(e.self_device_time_total
                             for e in kernels) / 1e3,
            "kernels": sum(e.count for e in kernels)}


def decode_stretch(torch, eng, prompts):
    """Wall per decode step of the warmed engine (its programs captured):
    one request per slot admitted, then FAMILY_REPLAYS steps of pure
    decode (1-step windows) timed on the host, the card synchronised
    around them; the rest drained.  Kernel 1 exact in the stretch."""
    st = eng.stats
    rids = [eng.submit(p, FAMILY_REPLAYS + 4) for p in prompts[:eng.slots]]
    n0 = st.prefills
    while st.prefills - n0 < len(rids):
        eng.step()
    torch.cuda.synchronize()
    _reset_counts()
    steps0, cap0 = st.device_decode_steps, st.graph_captures
    t0 = time.perf_counter()
    for _ in range(FAMILY_REPLAYS):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = st.device_decode_steps - steps0
    k1 = _read_counts()["paged_decode_attention"]
    eng.drain()
    if not steps or k1 != eng.cfg.n_layers * steps or \
            st.graph_captures != cap0:
        raise AssertionError(f"(11) {eng.cfg.name} decode stretch: {steps} "
                             f"steps, kernel 1 {k1}, captures "
                             f"{st.graph_captures - cap0}")
    return {"rows": len(rids), "device_decode_steps": steps,
            "wall_ms_per_step": wall * 1e3 / steps, "kernel_launches": k1}


def family_engine(torch, dev, model, params, prompts, max_new, kv_dtype,
                  tol):
    """The family's model through ``LPUEngine`` on graphs (every capture
    timed) and its eager twin (``graphs=False``), 4 slots, max_seq 512,
    blocks of 128, kernel 1 streamed: greedy streams equal or apart only
    at a top-2 gap <= ``tol`` (:func:`agree`), kernel 1 launched exactly
    once per layer per device decode step, chunk and prefix tail in each
    (per replay on graphs), every pool balanced; then, on the warmed
    engine, the wall of a stretch of pure decode steps
    (:func:`decode_stretch`) and one decode step's device time
    (:func:`window_step`): their ratio is the busy share of decode on
    graphs."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    cfg = model.cfg
    kw = dict(slots=FAMILY_SLOTS, max_seq=FAMILY_MAX_SEQ, block_size=BS,
              kv_dtype=kv_dtype, paged_kernel="stream")

    def run(graphs):
        what = f"(11) {cfg.name} graphs={graphs}"
        eng = LPUEngine(model, params, EngineConfig(**kw), device=dev,
                        graphs=graphs)
        _reset_counts()
        outs = eng.generate(prompts, max_new_tokens=max_new)
        torch.cuda.synchronize()
        k1 = path_counts({"paged_decode_attention"}, what)[
            "paged_decode_attention"]
        if eng.stats.device_decode_steps == 0 or k1 != launches_want(eng):
            raise AssertionError(f"{what}: kernel 1 launched {k1} times, "
                                 f"want {launches_want(eng)}")
        pool_checks(eng, what)
        on_graphs(eng)
        for o in outs:
            if len(o) != max_new or not all(0 <= t < cfg.vocab_size
                                            for t in o):
                raise AssertionError(f"{what}: bad stream {o}")
        return outs, eng, k1

    with capture_clock(torch) as spent:
        outs, eng, k1 = run(True)
    rec = run_rec(eng, k1, capture_s=dict(spent), requests=len(prompts),
                  distinct_tokens_per_stream=[len(set(o)) for o in outs],
                  kv_bytes_moved_per_step=eng.kv_bytes_moved_per_step())
    stretch = decode_stretch(torch, eng, prompts)
    rec["kernel_launches"] += stretch["kernel_launches"]
    rec["decode_step"] = step = window_step(torch, eng)
    stretch["device_busy_share"] = (step["device_ms_per_step"]
                                    / stretch["wall_ms_per_step"])
    rec["decode_stretch"] = stretch
    del eng
    eager, eeng, ek1 = run(False)
    rec["eager_twin"] = run_rec(eeng, ek1, vs_graphs=agree(
        torch, model, params, prompts, outs, eager, f"(11) {cfg.name}",
        tol=tol))
    rec["kernel_launches"] += ek1
    return rec


def llava_steps(torch, dev, model, params):
    """(c2): a prompt of 2880 seeded patch embeddings and LLAVA_TEXT text
    tokens through the port's prefill step (``core/steps.py``: the
    projector, the patches before the text), then LLAVA_STEPS serve
    steps at positions that count the patches; each token equal to its
    recompute twin's (a prefill over patches + text + the tokens so far,
    from a fresh cache) or apart only at the twin's top-2 gap <= bf16's
    tolerance.  The prefill's device ms under torch.profiler."""
    import numpy as np
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    cfg = model.cfg
    dt = torch.bfloat16
    n_p, S = cfg.vlm.n_patches, LLAVA_TEXT
    max_seq = n_p + S + LLAVA_STEPS
    g = torch.Generator(device=dev).manual_seed(11)
    patches = (0.1 * torch.randn((1, n_p, cfg.vlm.patch_embed_dim),
                                 generator=g, device=dev)).to(dt)
    rng = np.random.RandomState(11)
    text = torch.tensor(rng.randint(1, cfg.vocab_size, size=(1, S)),
                        device=dev)
    prefill, _ = build_prefill_step(model, None, 1, max_seq)
    serve_step, _ = build_serve_step(model, None, 1, max_seq)
    cache = model.init_cache(1, max_seq, dtype=dt)
    tok, cache = prefill(params, cache, text, patch_embeds=patches)
    toks = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(LLAVA_STEPS):
        pos = torch.tensor([n_p + S + t], dtype=torch.int32, device=dev)
        tok, cache = serve_step(params, cache, toks[-1][:, None].long(), pos)
        toks.append(tok)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) / LLAVA_STEPS * 1e3
    out = torch.cat(toks).tolist()
    kernels = device_kernels(lambda: (prefill(
        params, model.init_cache(1, max_seq, dtype=dt), text,
        patch_embeds=patches), torch.cuda.synchronize()))
    prefill_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    gaps, apart = [], []
    with torch.no_grad():
        for j in range(len(out)):
            grown = torch.cat([text, torch.tensor([out[:j]], device=dev,
                                                  dtype=text.dtype)], 1)
            logits, _ = model.forward(
                params, grown, mode="prefill", patch_embeds=patches,
                cache=model.init_cache(1, n_p + grown.shape[1], dtype=dt))
            row = logits[0, -1].float()
            gap = top2_gap(row).item()
            gaps.append(gap)
            if int(row.argmax()) != out[j]:
                if gap > TOL["bfloat16"]:
                    raise AssertionError(
                        f"(11) llava steps: token {j} is {out[j]}, the "
                        f"recompute twin's {int(row.argmax())} at a top-2 "
                        f"gap {gap}")
                apart.append({"at": j, "top2_gap": gap})
    if not all(0 <= t < cfg.vocab_size for t in out):
        raise AssertionError(f"(11) llava steps: bad tokens {out}")
    return {"patches": n_p, "patch_embed_dim": cfg.vlm.patch_embed_dim,
            "text_tokens": S, "serve_steps": LLAVA_STEPS,
            "tokens": out, "distinct_tokens": len(set(out)),
            "equal_to_recompute": len(out) - len(apart),
            "apart_at_near_ties": apart, "min_top2_gap": min(gaps),
            "prefill_device_ms": prefill_ms,
            "prefill_kernels": sum(e.count for e in kernels),
            "serve_wall_ms_per_step": serve_ms}


def run_whisper(torch, dev):
    """(d): whisper-tiny, whole, f32, through the serving steps:
    WHISPER_ROWS rows of seeded (1500, 384) frames with
    WHISPER_PROMPT-token prompts prefilled (the encoder runs once, the
    cross K/V go into the cache), then WHISPER_STEPS serve steps reading
    them; each token equal to its recompute twin's (a prefill over the
    prompt + the tokens so far, the encoder run again) or apart only at
    its top-2 gap <= CHAIN_TOL.  Wall and device ms per serve step."""
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    model, params, rec = family_model(torch, dev, "whisper-tiny", "float32")
    cfg = model.cfg
    rows, S, steps = WHISPER_ROWS, WHISPER_PROMPT, WHISPER_STEPS
    max_seq = 64
    frames, prompt = whisper_inputs(torch, dev, cfg)
    prefill, _ = build_prefill_step(model, None, rows, max_seq)
    serve_step, _ = build_serve_step(model, None, rows, max_seq)
    cache = model.init_cache(rows, max_seq)
    tok, cache = prefill(params, cache, prompt, frames=frames)
    toks = [tok]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for t in range(steps):
        pos = torch.full((rows,), S + t, dtype=torch.int32, device=dev)
        tok, cache = serve_step(params, cache, toks[-1][:, None].long(), pos)
        toks.append(tok)
    stop.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    out = torch.stack(toks, 1)                       # (rows, steps + 1)
    pos = torch.full((rows,), S + steps, dtype=torch.int32, device=dev)
    kernels = device_kernels(lambda: (serve_step(
        params, cache, out[:, -1:].long(), pos), torch.cuda.synchronize()))
    apart, gaps = [], []
    with torch.no_grad():
        for j in range(out.shape[1]):
            grown = torch.cat([prompt, out[:, :j].to(prompt.dtype)], 1)
            logits, _ = model.forward(
                params, grown, mode="prefill", frames=frames,
                cache=model.init_cache(rows, grown.shape[1]))
            row = logits[:, -1].float()
            gap = top2_gap(row)
            gaps.append(gap.min().item())
            for r in range(rows):
                if int(row[r].argmax()) != int(out[r, j]):
                    if gap[r].item() > CHAIN_TOL:
                        raise AssertionError(
                            f"(11) whisper: row {r} token {j} is "
                            f"{int(out[r, j])}, the recompute twin's "
                            f"{int(row[r].argmax())} at a top-2 gap "
                            f"{gap[r].item()}")
                    apart.append({"row": r, "at": j,
                                  "top2_gap": gap[r].item()})
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError("(11) whisper: bad tokens")
    rec.update(rows=rows, enc_seq=cfg.encdec.enc_seq,
               enc_layers=cfg.encdec.n_enc_layers, prompt_tokens=S,
               serve_steps=steps, tokens=out.tolist(),
               distinct_tokens=len(set(out.flatten().tolist())),
               checked=out.numel(),
               equal_to_recompute=out.numel() - len(apart),
               apart_at_near_ties=apart, min_top2_gap=min(gaps),
               serve_wall_ms_per_step=wall_ms,
               serve_event_ms_per_step=start.elapsed_time(stop) / steps,
               serve_device_busy_ms_per_step=sum(
                   e.self_device_time_total for e in kernels) / 1e3,
               serve_kernels_per_step=sum(e.count for e in kernels))
    return rec


def free_card(torch, what):
    """Collect and empty the allocator's cache; fail if more than 2 GB
    is still allocated (a model of an earlier run still held)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    if held > 2e9:
        raise AssertionError(f"{held} bytes still allocated {what}")
    return held


def run_families(torch, dev, card_name):
    """Phase 11: kernel 1 at the three new GQA shapes, then (a) granite
    at full width, depth 8, in f32 through the engine, (b) llama4 at
    depth 2 in bf16, (c) llava at depth 8 in bf16 through the engine and
    through the steps with 2880 patches, (d) whisper-tiny through the
    steps; each model freed before the next loads."""
    t0 = time.perf_counter()
    laps = {}

    def lap(what, t):
        laps[what] = time.perf_counter() - t
        print(f"[time] (11) {what} {laps[what]:.1f} s", flush=True)
        return time.perf_counter()
    rec = {"card": card_name, "held_before_bytes": free_card(
        torch, "before phase 11")}
    t = time.perf_counter()
    rec["kernel1"] = check_time_family_k1(torch, dev, card_name)
    t = lap("kernel 1", t)

    model, params, m = family_model(torch, dev, "granite-moe-3b-a800m",
                                    "float32", GRANITE_DEPTH)
    prompts = family_prompts(model.cfg, GRANITE_REQUESTS)
    m["engine"] = family_engine(torch, dev, model, params, prompts,
                                GRANITE_NEW, "auto", CHAIN_TOL)
    m["expert_loop"] = expert_loop(torch, dev, model, params, FAMILY_SLOTS)
    rec["granite"] = m
    del model, params
    free_card(torch, "after granite")
    t = lap("(a) granite", t)

    for key, name, depth in (("llama4", "llama4-maverick-400b-a17b",
                              LLAMA4_DEPTH),
                             ("llava", "llava-next-34b", LLAVA_DEPTH)):
        model, params, m = family_model(torch, dev, name, "bfloat16", depth)
        prompts = family_prompts(model.cfg, BF16_REQUESTS, seed=1)
        m["engine"] = family_engine(torch, dev, model, params, prompts,
                                    BF16_NEW, "bfloat16", TOL["bfloat16"])
        if model.cfg.moe is not None:
            m["expert_loop"] = expert_loop(torch, dev, model, params,
                                           FAMILY_SLOTS)
        if model.cfg.vlm is not None:
            m["steps"] = llava_steps(torch, dev, model, params)
        rec[key] = m
        del model, params
        free_card(torch, f"after {key}")
        t = lap(f"({'b' if key == 'llama4' else 'c'}) {key}", t)
    rec["whisper"] = run_whisper(torch, dev)
    free_card(torch, "after whisper")
    lap("(d) whisper", t)
    rec["kernel_launches"] = sum(rec[k]["engine"]["kernel_launches"]
                                 for k in ("granite", "llama4", "llava"))
    rec["laps_s"] = laps
    rec["phase_s"] = time.perf_counter() - t0
    return rec


TRAIN_RUN = dict(steps=30, global_batch=8, seq_len=512, lr=6e-4,
                 schedule="cosine", seed=0)
TRAIN_CKPT_EVERY = 8
TRAIN_CRASH_AT = 12
TRAIN_WARM, TRAIN_TIMED = 2, 5
TRAIN_ACCUM = 4


class TimedOptimizer:
    """An optimizer that records CUDA events around the wrapped one's
    ``apply``: its device ms per call, read after a synchronize."""

    def __init__(self, torch, opt):
        self.torch, self.opt, self.events = torch, opt, []

    def apply(self, params, grads, state, norm_sq):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.opt.apply(params, grads, state, norm_sq=norm_sq)
        ev[1].record()
        self.events.append(ev)
        return out

    def device_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]


def train_flops_per_step(cfg, params, tokens, seq):
    """6 N tokens (N every parameter: the tied embedding is the head's
    product) plus attention's scores and weighted sums, forward and
    backward, over the full S x S square the plain attention computes:
    12 L H dh S per token."""
    from repro_torch.tree import tree_leaves
    n = sum(p.numel() for p in tree_leaves(params))
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.d_head * seq
    return n, (6 * n + attn) * tokens


def check_kernels_refuse_grad(torch, dev):
    """Each kernel wrapper, given an input on the card that requires
    grad, raises before it launches (its output would carry no
    autograd history)."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.gemv.ops import gemv
    from repro_torch.kernels.mamba_scan.ops import (mamba_scan,
                                                    mamba_scan_fused)
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan

    def r(*shape):
        return torch.rand(shape, device=dev)
    lens = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    tables = torch.tensor([[1, 2], [2, 1]], dtype=torch.int32, device=dev)
    calls = {
        "gemv": ((2, 8), lambda x: gemv(x, r(8, 4))),
        "decode_attention": ((2, 2, 4), lambda q: decode_attention(
            q, r(2, 6, 1, 4), r(2, 6, 1, 4), lens)),
        "paged_decode_attention": ((2, 2, 4), lambda q: paged_decode_attention(
            q, r(3, 4, 1, 4), r(3, 4, 1, 4), tables, lens)),
        "rwkv_scan": ((1, 3, 2, 4), lambda x: rwkv_scan(
            x, r(1, 3, 2, 4), r(1, 3, 2, 4), r(1, 3, 2, 4), r(2, 4),
            r(1, 2, 4, 4))),
        "mamba_scan": ((1, 3, 5, 2), lambda x: mamba_scan(
            x, r(1, 3, 5, 2), r(1, 3, 2), r(1, 5, 2))),
        "mamba_scan_fused": ((1, 3, 5), lambda x: mamba_scan_fused(
            x, r(1, 3, 5), -r(5, 2), r(1, 3, 2), r(1, 3, 2), r(1, 5, 2))),
    }
    refused = {}
    for name, (shape, call) in calls.items():
        x = torch.rand(shape, device=dev, requires_grad=True)
        try:
            call(x)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            refused[name] = True
        else:
            raise AssertionError(f"{name} launched on an input that "
                                 "requires grad")
    return refused


def run_training_phase(torch, dev, card_name):
    """Phase 12: (a) 30 steps of full-width smollm-135m, (b) the same
    run crashed at step 12 and resumed from its step-8 checkpoint, (c)
    accumulation 1 against 4 and the step's times, (d) no kernel
    launched and each wrapper refusing an input that requires grad."""
    import statistics
    import tempfile

    from repro_torch import kernels
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.core.steps import build_train_step
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.ft import FailureInjector
    from repro_torch.launch.train import run_training
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW, get_schedule
    from repro_torch.tree import tree_map

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 12 trains with TF32 off")
    t0 = time.perf_counter()
    rec = {"card": card_name, "held_before_bytes": free_card(
        torch, "before phase 12")}
    cfg = get_config("smollm-135m")
    run = dict(TRAIN_RUN, cfg=cfg, device=dev)
    kernels.reset_launches()

    t = time.perf_counter()
    _, _, losses = run_training(**run)
    rec["a"] = {"losses": losses, "wall_s": time.perf_counter() - t}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(a) a loss is not finite: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    rec["a"].update(first5_mean=first, last5_mean=last)
    if not last < first - 0.5:
        raise AssertionError(f"(a) the loss did not fall by 0.5: mean of "
                             f"the first 5 {first}, of the last 5 {last}")

    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as d:
        try:
            run_training(**run, ckpt_dir=d, ckpt_every=TRAIN_CKPT_EVERY,
                         injector=FailureInjector([TRAIN_CRASH_AT]))
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise AssertionError("(b) the injector did not fire")
        crashed_at = CheckpointManager(d).latest_step()
        _, _, resumed = run_training(**run, ckpt_dir=d,
                                     ckpt_every=TRAIN_CKPT_EVERY)
    start = len(losses) - len(resumed)
    tail = losses[start:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, tail))
    rec["b"] = {"resumed_at_step": start, "latest_checkpoint": crashed_at,
                "losses": resumed, "max_rel_diff_vs_a": rel,
                "bit_equal_to_a": resumed == tail,
                "wall_s": time.perf_counter() - t}
    if start != TRAIN_CKPT_EVERY or not rel <= 1e-4:
        raise AssertionError(f"(b) resumed at step {start}, losses "
                             f"{resumed} against (a)'s {tail}")

    plan = plan_model(cfg, None, (1,), "train", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, dev)
    opt = AdamW(lr=get_schedule("cosine", TRAIN_RUN["lr"], 1,
                                TRAIN_RUN["steps"]))
    data = SyntheticLM(cfg.vocab_size, TRAIN_RUN["seq_len"], seed=0)
    B = TRAIN_RUN["global_batch"]

    def batch(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i, B).items()}
    params0 = model.init(0)
    t = time.perf_counter()
    accum = {}
    for n in (1, TRAIN_ACCUM):
        params = tree_map(torch.clone, params0)
        step, _ = build_train_step(model, opt, None, B, accum_steps=n)
        _, _, m = step(params, opt.init(params), batch(0))
        accum[n] = float(m["loss"])
        del params
    rec["c"] = {"accum_losses": accum, "accum_s": time.perf_counter() - t}
    if not abs(accum[1] - accum[TRAIN_ACCUM]) < 1e-5:
        raise AssertionError(f"(c) accumulation: {accum}")

    timed = TimedOptimizer(torch, opt)
    step, _ = build_train_step(model, timed, None, B)
    params, state = params0, opt.init(params0)
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARM + TRAIN_TIMED):
        b = batch(i)
        t = time.perf_counter()
        params, state, m = step(params, state, b)
        float(m["loss"])
        walls.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    opt_ms = timed.device_ms()[TRAIN_WARM:]
    b = batch(TRAIN_WARM + TRAIN_TIMED)

    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, b)
        torch.cuda.synchronize()
    t = time.perf_counter()
    prof = device_kernels(one_step)
    profile_s = time.perf_counter() - t
    busy_us = sum(e.self_device_time_total for e in prof)
    top = sorted(prof, key=lambda e: -e.self_device_time_total)[:10]
    with tempfile.TemporaryDirectory(prefix="train_save_") as d:
        t = time.perf_counter()
        CheckpointManager(d).save(0, {"params": params, "opt": state})
        save_s = time.perf_counter() - t
    tokens = B * TRAIN_RUN["seq_len"]
    n_params, flops = train_flops_per_step(cfg, params, tokens,
                                           TRAIN_RUN["seq_len"])
    ms = statistics.median(walls[TRAIN_WARM:]) * 1e3
    rec["c"].update(
        step_walls_ms=[w * 1e3 for w in walls], ms_per_step=ms,
        tokens_per_s=tokens / ms * 1e3,
        step_device_ms=busy_us / 1e3 if busy_us else None,
        step_kernels=sum(e.count for e in prof),
        device_busy_share=busy_us / 1e3 / ms if busy_us else None,
        top_kernels=[{"name": e.key[:80], "count": e.count,
                      "ms": e.self_device_time_total / 1e3} for e in top],
        peak_memory_bytes=peak,
        optimizer_device_ms=statistics.median(opt_ms),
        checkpoint_save_s=save_s, profile_s=profile_s, params=n_params,
        flops_per_step=flops,
        mfu_f32=flops / (ms / 1e3) / PEAK_OPS["float32"])
    del params, state, params0, model

    rec["d"] = {"launches": kernels.read_launches(),
                "refused": check_kernels_refuse_grad(torch, dev)}
    if any(rec["d"]["launches"].values()):
        raise AssertionError(f"(d) training launched a kernel: "
                             f"{rec['d']['launches']}")
    free_card(torch, "after phase 12")
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ---------------------------------------------------------------------------
# phase 13: tensor parallelism over the ESL ring, ranks as processes
# ---------------------------------------------------------------------------

TP = 2
TP_NEW = 32


def check_kernel1_at_rank(torch, dev, plan, rank, seed):
    """Kernel 1 against its plain version at this rank's shapes (the
    engine's 4 slots, its q_per_rank query and kv_per_rank kv heads, f32
    pool of 17 blocks of 128, the fold), outside the counted run.
    Returns the max abs error."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    from repro_torch.kernels import held_launches
    a = plan.attn
    g = torch.Generator(device=dev).manual_seed(seed + rank)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q, kn, vn = (rnd(B, a.q_per_rank, a.d_head),
                 rnd(B, a.kv_per_rank, a.d_head),
                 rnd(B, a.kv_per_rank, a.d_head))
    kp, vp = (rnd(N, BS, a.kv_per_rank, a.d_head),
              rnd(N, BS, a.kv_per_rank, a.d_head))
    tables = torch.zeros((B, T), dtype=torch.int32)
    for b, n in enumerate(LENGTHS):
        used = -(-n // BS)
        tables[b, :used] = torch.arange(1 + T * b, 1 + T * b + used)
    tables = tables.to(dev)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    with held_launches():
        got = paged_decode_attention(q, kp, vp, tables, lengths, k_new=kn,
                                     v_new=vn)
    want = paged_decode_attention_ref(q, kp, vp, tables, lengths, k_new=kn,
                                      v_new=vn)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or err > TOL["float32"]:
        raise AssertionError(f"(13) kernel 1 at rank {rank}'s shapes "
                             f"{tuple(q.shape)} / {tuple(kp.shape)}: max "
                             f"abs {err} > {TOL['float32']}")
    return err


def pad_heads_silent(plan, params, rank):
    """The query heads of this rank whose kv head is a pad head (stored
    kv index with ``kv_orig`` -1): their wq columns and wo rows are zero
    in every layer, so their output cannot reach the logits.  Returns
    how many there are."""
    a = plan.attn
    kv0 = rank * a.kv_per_rank
    local = a.q_to_kv_local[rank]
    pads = [i for i, c in enumerate(local) if a.kv_orig[kv0 + c] < 0]
    at = params["blocks"]["l0"]["attn"]
    for i in pads:
        if at["wq"][:, :, i].abs().max().item() != 0 or \
                at["wo"][:, i].abs().max().item() != 0:
            raise AssertionError(f"(13) rank {rank}: pad head {i} has "
                                 "non-zero weights")
    return len(pads)


def ring_plans(cfg, tp, dtype="float32"):
    """{esl_overlap: the serving plan of ``cfg`` on a ring of ``tp``}
    (both modes store the weights at the same layout)."""
    from repro_torch.compiler.mapper import plan_model
    return {ov: plan_model(cfg, ("model",), (tp,), "serve", esl_overlap=ov,
                           remat="none", compute_dtype=dtype,
                           param_dtype=dtype)
            for ov in (True, False)}


def spec_counts(eng):
    """A speculative run's counters, its drafts' digest and count."""
    st = eng.stats
    props = eng.drafter.proposals
    return {"spec_rounds": st.spec_rounds, "draft_tokens": st.draft_tokens,
            "accepted_tokens": st.accepted_tokens,
            "acceptance_rate": st.acceptance_rate,
            "accepted_per_window": st.accepted_per_window,
            "proposals": len(props),
            "proposals_crc32": zlib.crc32(json.dumps(props).encode())}


def tp_rank(ring, spec, jamba=None, whisper=None):
    """One rank of phase 13: for each model of ``spec``, this rank's
    shard drawn alone (:func:`rank_weights`: the tp=1 values at the
    ring's layout, no full tree), kernel 1 checked at the rank's shapes,
    then each run served by this rank's engine (steps eager on the gloo
    ring; a speculative run's drafts logged), kernel 1's launches counted
    from zero just before the run and read just after; then (c) jamba
    and (e) whisper-tiny through the ring's steps.  Returns every rank's
    record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    dev = ring.device
    out = {"rank": ring.rank, "models": {}}
    for name, runs in spec:
        t0 = time.perf_counter()
        cfg = get_config(name)
        plans = ring_plans(cfg, ring.size)
        params = rank_weights(cfg, plans[True], ring.rank, dev)
        rec = {"setup_s": time.perf_counter() - t0,
               "pad_heads": pad_heads_silent(plans[True], params, ring.rank),
               "kernel1_max_abs_err": check_kernel1_at_rank(
                   torch, dev, plans[True], ring.rank, len(out["models"])),
               "kernel1_shapes": {"q_heads": plans[True].attn.q_per_rank,
                                  "kv_heads": plans[True].attn.kv_per_rank,
                                  "dh": cfg.d_head},
               "runs": {}}
        for run in runs:
            model = build_model(cfg, plans[run["overlap"]], dev)
            eng = LPUEngine(model, params, EngineConfig(
                slots=4, max_seq=512, block_size=BS, **run["knobs"]),
                mesh=ring, device=dev, graphs=False)
            if run is runs[0]:
                # the process's first uses (cuBLAS, the kernel library,
                # the pinned host pool) outside the timed runs
                eng.generate(run["prompts"][:1], max_new_tokens=2)
                torch.cuda.synchronize()
                eng.stats = type(eng.stats)()
            if eng.drafter is not None:
                from repro_torch.serving.drafter import ProposalLog
                eng.drafter = ProposalLog(eng.drafter)
            paged_decode_attention.launches = 0
            ring.reset_counters()
            t1 = time.perf_counter()
            streams = eng.generate(run["prompts"], max_new_tokens=TP_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = paged_decode_attention.launches
            eng.check_pool_balanced()
            st = eng.stats
            want = launches_want(eng)
            if launches != want or not launches:
                raise AssertionError(
                    f"(13) {name} {run['key']} rank {ring.rank}: kernel 1 "
                    f"launches {launches} != {want}")
            steps = max(st.device_decode_steps, 1)
            rec["runs"][run["key"]] = {
                "streams": streams, "wall_s": wall,
                "tokens": st.tokens, "tokens_per_s": st.tokens / wall,
                "decode_steps": st.steps,
                "device_decode_steps": st.device_decode_steps,
                "prefill_chunks": st.prefill_chunks,
                "prefills": st.prefills,
                "kernel1_launches": launches, "kernel1_want": want,
                "collectives": ring.counters["collectives"],
                "hops": ring.counters["hops"],
                "staged_bytes": ring.counters["staged_bytes"],
                "collectives_per_decode_step":
                    ring.counters["collectives"] / steps,
                "hops_per_decode_step": ring.counters["hops"] / steps,
                "staged_bytes_per_decode_step":
                    ring.counters["staged_bytes"] / steps,
                # host time inside the collectives (staging, gloo, the
                # device's work they wait for)
                "ring_s": ring.counters["seconds"],
                "per_rank_kv_bytes": eng.per_rank_kv_bytes(),
                "kv_cache_bytes": eng.kv_cache_bytes()}
            if eng.drafter is not None:
                rec["runs"][run["key"]].update(spec_counts(eng))
            del eng, model
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out["models"][name] = rec
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if jamba is not None:
        out["jamba"] = tp_jamba_rank(torch, ring, jamba)
    if whisper is not None:
        t0 = time.perf_counter()
        out["whisper"] = ring_whisper(torch, ring, whisper, "(13e)")
        out["whisper"]["rank_s"] = time.perf_counter() - t0
    out["backend"] = ring.backend
    return ring.gather_object(out)


def whisper_inputs(torch, dev, cfg):
    """Phase 11 (d)'s seeded input: WHISPER_ROWS rows of (1500, 384)
    frames and WHISPER_PROMPT-token prompts (the same on every card)."""
    import numpy as np
    g = torch.Generator(device=dev).manual_seed(13)
    frames = 0.1 * torch.randn((WHISPER_ROWS, cfg.encdec.enc_seq,
                                cfg.d_model), generator=g, device=dev)
    rng = np.random.RandomState(13)
    prompt = torch.tensor(rng.randint(1, cfg.vocab_size,
                                      size=(WHISPER_ROWS, WHISPER_PROMPT)),
                          device=dev)
    return frames, prompt


def ring_whisper(torch, ring, spec, what):
    """whisper-tiny whole, f32, at this rank: its shard drawn alone
    (``init_shard``, seed 0: phase 11's weights), phase 11 (d)'s frames
    and prompts through the ring's ``build_prefill_step`` and
    ``spec["steps"]`` serve steps (ESL overlap); each token against
    ``spec["want"]`` (tp=1's), equal or apart only where the ring's own
    recompute (a prefill over the prompt + the tokens so far) has a
    top-2 gap <= CHAIN_TOL.  Every rank calls it alike."""
    from repro_torch.configs import get_config
    from repro_torch.core import esl
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    from repro_torch.models.registry import build_model
    from repro_torch.weights import init_shard
    dev = ring.device
    cfg = get_config("whisper-tiny")
    plan = ring_plans(cfg, ring.size)[True]
    t0 = time.perf_counter()
    params = init_shard(cfg, plan, ring.rank, seed=0, device=dev)
    model = build_model(cfg, plan, dev)
    setup = time.perf_counter() - t0
    frames, prompt = whisper_inputs(torch, dev, cfg)
    rows, S, steps = WHISPER_ROWS, WHISPER_PROMPT, spec["steps"]
    max_seq = 64
    prefill, meta = build_prefill_step(model, ring, rows, max_seq)
    serve_step, _ = build_serve_step(model, ring, rows, max_seq)
    ring.reset_counters()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tok, cache = prefill(params, model.init_cache(rows, max_seq), prompt,
                         frames=frames)
    toks = [tok]
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    for t in range(steps):
        pos = torch.full((rows,), S + t, dtype=torch.int32, device=dev)
        tok, cache = serve_step(params, cache, toks[-1][:, None].long(), pos)
        toks.append(tok)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    out = torch.stack(toks, 1).tolist()
    counts = dict(ring.counters)
    want = [w[:steps + 1] for w in spec["want"]]
    apart = []
    for r in range(rows):
        at = next((j for j, (u, v) in enumerate(zip(out[r], want[r]))
                   if u != v), None)
        if at is None:
            continue
        grown = torch.cat([prompt, torch.tensor(out, device=dev)[:, :at]
                           .to(prompt.dtype)], 1)
        with torch.no_grad():
            lg, _ = model.forward(params, grown, mode="prefill",
                                  frames=frames, env=meta["env"],
                                  cache=model.init_cache(rows,
                                                         grown.shape[1]))
            row = esl.gather_scattered(lg[r, -1].float(), axis=ring,
                                       tp=ring.size)
        gap = top2_gap(row[None])[0].item()
        if gap > CHAIN_TOL:
            raise AssertionError(f"{what} whisper tp {ring.size} rank "
                                 f"{ring.rank}: row {r} token {at} is "
                                 f"{out[r][at]}, tp=1's {want[r][at]}, at a "
                                 f"top-2 gap {gap}")
        apart.append({"row": r, "at": at, "top2_gap": gap})
    del model, params
    free_cuda(torch)
    return {"tokens": out, "rows": rows, "serve_steps": steps,
            "equal": rows - len(apart), "of": rows,
            "diverged_at_near_ties": apart, "setup_s": setup,
            "prefill_s": t1 - t0,
            "serve_wall_ms_per_step": (t2 - t1) * 1e3 / steps,
            "collectives": counts["collectives"],
            "staged_bytes": counts["staged_bytes"]}


def run_tp(torch, dev, card_name, tp1):
    """Phase 13: full-width opt-1.3b (f32, biases and positions redrawn
    non-zero) at tp 2 in ESL overlap, and full-width smollm-135m at tp 2
    in blocking (3 kv heads padded to 4: rank 1's second kv head a pad
    head), two ranks on the one card over gloo, the steps eager (opt's
    blocking runs moved to phase 14, on NCCL); each run's greedy streams
    equal to the tp=1 engine's (``tp1``: {name: (prompts, streams)} from
    the earlier phases) or apart only at a top-2 gap <= CHAIN_TOL of the
    tp=1 model, kernel 1 launched exactly n_layers x (decode steps +
    verify rounds + chunks) on every rank.  (e): smollm-135m in blocking
    again with the n-gram drafter (draft_k SPEC_K), every rank proposing
    and accepting the same drafts; then whisper-tiny whole through the
    ring's steps (:func:`ring_whisper`) against phase 11 (d)'s tokens
    (``tp1["whisper-tiny"]``)."""
    from repro_torch.core.dist import run_ranks
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    opt_prompts_, _ = tp1["opt-1.3b"]
    sm_prompts, _ = tp1["smollm-135m"]
    spec = [
        ("opt-1.3b", [
            dict(key="overlap", overlap=True, knobs={},
                 prompts=opt_prompts_)]),
        ("smollm-135m", [
            dict(key="blocking", overlap=False, knobs={},
                 prompts=sm_prompts),
            dict(key="blocking_ngram", overlap=False,
                 knobs=dict(speculate="ngram", draft_k=SPEC_K),
                 prompts=sm_prompts)])]
    t_j = time.perf_counter()
    j_draw = jamba_shard_peak(torch, dev)
    # (c)'s tp=1 reference: jamba cut to one super-block, eager
    cfg_j = fam_cfg("jamba-v0.1-52b", TP_JAMBA_DEPTH)
    j_prompts = family_prompts(cfg_j, TP_JAMBA_PROMPTS, seed=13)
    j_want, j_rec = tp1_streams(torch, dev, "jamba-v0.1-52b",
                                TP_JAMBA_DEPTH, j_prompts, TP_JAMBA_NEW,
                                TP_JAMBA_MAX_SEQ, False)
    j_tp1_s = time.perf_counter() - t_j
    t_r = time.perf_counter()
    per_rank = run_ranks(tp_rank, TP, spec, dict(
        depth=TP_JAMBA_DEPTH, prompts=j_prompts, new=TP_JAMBA_NEW,
        want=j_want), dict(want=tp1["whisper-tiny"], steps=TP_WHISPER_STEPS),
        device=dev, placement="shared_card")
    spawn_s = time.perf_counter() - t_r
    out = {"tp": TP, "backend": per_rank[0]["backend"], "graphs": False,
           "ranks_on_one_card": True, "card": card_name, "models": {}}
    for name, runs in spec:
        prompts, want = tp1[name]
        recs = [r["models"][name] for r in per_rank]
        m = {"setup_s": [r["setup_s"] for r in recs],
             "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                            for r in recs],
             "pad_heads_per_rank": [r["pad_heads"] for r in recs],
             "kernel1_max_abs_err_per_rank": [r["kernel1_max_abs_err"]
                                              for r in recs],
             "kernel1_shapes": recs[0]["kernel1_shapes"], "runs": {}}
        model = params = None
        for run in runs:
            k = run["key"]
            rr = [r["runs"][k] for r in recs]
            if any(x["streams"] != rr[0]["streams"] for x in rr):
                raise AssertionError(f"(13) {name} {k}: the ranks' streams "
                                     "differ")
            if "spec_rounds" in rr[0]:
                same_on_ranks(rr, lambda x: [x[f] for f in (
                    "spec_rounds", "draft_tokens", "accepted_tokens",
                    "proposals", "proposals_crc32")],
                    f"(13e) {name} {k} drafts and acceptance")
                if not rr[0]["spec_rounds"]:
                    raise AssertionError(f"(13e) {name} {k}: no verify "
                                         "round")
            got = rr[0]["streams"]
            if got == want:
                vs = {"equal": len(want), "diverged_at_near_ties": []}
            else:
                if model is None:
                    model, params = (opt_model(torch, dev, name)
                                     if name == "opt-1.3b"
                                     else smollm(torch, dev)[:2])
                vs = agree(torch, model, params, prompts, got, want,
                           f"(13) {name} tp {TP} {k}")
            r0 = dict(rr[0])
            r0.pop("streams")
            m["runs"][k] = dict(
                r0, vs_tp1=vs,
                kernel1_launches_per_rank=[x["kernel1_launches"]
                                           for x in rr],
                staged_bytes_per_decode_step_per_rank=[
                    x["staged_bytes_per_decode_step"] for x in rr])
        del model, params
        out["models"][name] = m
    jr = [r["jamba"] for r in per_rank]
    if any(x["streams"] != jr[0]["streams"] for x in jr):
        raise AssertionError("(13c) jamba: the ranks' streams differ")
    out["jamba"] = {
        "arch": "jamba-v0.1-52b", "dtype": "float32",
        "n_layers": TP_JAMBA_DEPTH, "mode": "overlap",
        "schedule": jamba_schedule(cfg_j), "tp1": j_rec, "tp1_s": j_tp1_s,
        "whole_shard_draw": j_draw,
        "prompt_lengths": [len(p) for p in j_prompts],
        "new_tokens": TP_JAMBA_NEW,
        **{k: jr[0][k] for k in ("wall_s", "tokens", "device_decode_steps",
                                 "prefills", "kernel_want", "collectives",
                                 "hops", "staged_bytes",
                                 "seconds_in_collective_calls",
                                 "cache_shapes", "vs_tp1", "kernel5_shape")},
        "kernel5_launches_per_rank": [x["kernel_launches"] for x in jr],
        "kernel5_at_rank_per_rank": [x["kernel5_at_rank"] for x in jr],
        "weight_bytes_per_rank": [x["weight_bytes"] for x in jr],
        "peak_memory_bytes_per_rank": [x["peak_memory_bytes"] for x in jr],
        "setup_s": [x["setup_s"] for x in jr]}
    wr = [r["whisper"] for r in per_rank]
    same_on_ranks(wr, lambda x: x["tokens"], "(13e) whisper tokens")
    out["whisper"] = dict({k: v for k, v in wr[0].items()
                           if k != "tokens"},
                          rank_s=[x["rank_s"] for x in wr],
                          tokens_head=[t[:4] for t in wr[0]["tokens"]])
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    out["ranks_s"] = spawn_s
    return out


# (13e): whisper-tiny's serve steps on the ring, against phase 11 (d)
TP_WHISPER_STEPS = 8

# (13c): jamba-v0.1-52b at full width, one super-block, bf16, tp 2
TP_JAMBA_DEPTH = 8
TP_JAMBA_NEW = 8
TP_JAMBA_PROMPTS = 2


def tree_bytes(params):
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def kernel5_at_rank(torch, dev, shapes, seed):
    """Kernel 5's fused entry against its plain version at a rank's
    shapes, outside any counted run: {shape: max abs error, bit-equal};
    raises past MAMBA_TOL."""
    from repro_torch.kernels import held_launches
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_fused_ref
    out = {}
    for i, shape in enumerate(shapes):
        args = mamba_fused_inputs(torch, dev, shape, seed + i)
        with held_launches():
            got = mamba_scan_fused(*args)
        want = mamba_scan_fused_ref(*args)
        torch.cuda.synchronize(dev)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        if not all(torch.isfinite(t).all() for t in got) or err > MAMBA_TOL:
            raise AssertionError(f"mamba_scan_fused at a rank's shape "
                                 f"{shape}: max abs {err} > {MAMBA_TOL}")
        out["x".join(map(str, shape))] = {
            "max_abs_err": err,
            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, want))}
    return out


def n_scan_layers(cfg):
    """Layers that launch the family's scan kernel once per decode step
    (and, mamba, once per prefill)."""
    if cfg.family == "rwkv":
        return cfg.n_layers
    return sum(not cfg.is_attention_layer(i) for i in range(cfg.n_layers))


def tp_jamba_rank(torch, ring, spec):
    """(13c) at this rank: jamba at full width cut to one super-block,
    f32, this rank's shard drawn alone, kernel 5 held against its plain
    version at the rank's shapes, then the prompts served in ESL overlap
    (steps eager on the gloo ring), kernel 5's launches counted from
    zero over the run; the streams against tp=1's, apart only at a
    top-2 gap <= CHAIN_TOL of the ring's model (every rank calls it
    alike)."""
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
    from repro_torch.models.mamba import mamba_dims
    from repro_torch.models.registry import build_model
    from repro_torch.weights import init_shard
    dev = ring.device
    cfg = fam_cfg("jamba-v0.1-52b", spec["depth"])
    plan = ring_plans(cfg, ring.size)[True]
    t0 = time.perf_counter()
    params = init_shard(cfg, plan, ring.rank, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    _, d_loc = mamba_dims(cfg, plan)
    prompts = spec["prompts"]
    rec = {"setup_s": time.perf_counter() - t0,
           "weight_bytes": tree_bytes(params),
           "kernel5_at_rank": kernel5_at_rank(
               torch, dev,
               [(len(prompts), 1, d_loc, cfg.mamba.d_state),
                (1, max(map(len, prompts)), d_loc, cfg.mamba.d_state)],
               seed=70 + ring.rank),
           "kernel5_shape": [len(prompts), 1, d_loc, cfg.mamba.d_state]}
    model = build_model(cfg, plan, dev)
    streams, run = ring_engine_run(torch, ring, model, params, prompts,
                                   spec["new"], False,
                                   max_seq=TP_JAMBA_MAX_SEQ)
    rec.update(run, streams=streams,
               cache_shapes=run.pop("cache_shapes"),
               vs_tp1=ring_agree(torch, ring, model, params, prompts,
                                 streams, spec["want"], CHAIN_TOL,
                                 f"(13c) jamba tp {ring.size} rank "
                                 f"{ring.rank}"),
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
    del model, params
    free_cuda(torch)
    return rec


TP_JAMBA_MAX_SEQ = 128


def jamba_shard_peak(torch, dev):
    """(13d) jamba-v0.1-52b whole, rank 0's shard at tp 2 in bf16, drawn
    on this card alone (a shard is a function of the rank; no ring):
    its bytes, the draw's wall and its peak above the shard, held to
    less than two of the largest tp=1 layers (an MoE layer's experts)."""
    from repro_torch.weights import init_shard
    cfg = fam_cfg("jamba-v0.1-52b")
    plan = ring_plans(cfg, TP, "bfloat16")[True]
    free_cuda(torch)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_shard(cfg, plan, 0, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    rec = {"draw_s": time.perf_counter() - t0,
           "shard_bytes": tree_bytes(params),
           "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
           "moe_layer_tp1_bytes": 3 * 2 * cfg.moe.n_experts * cfg.d_model
           * cfg.moe.d_ff_expert}
    rec["peak_over_shard_bytes"] = rec["peak_bytes"] - rec["shard_bytes"]
    del params
    free_cuda(torch)
    if rec["peak_over_shard_bytes"] > 2 * rec["moe_layer_tp1_bytes"]:
        raise AssertionError(f"(13d) jamba's shard drew {rec}")
    return rec


def tp1_streams(torch, dev, name, depth, prompts, new, max_seq, graphs):
    """A tp=1 reference on ``dev``: ``name`` at full width (its depth
    cut to ``depth``) in f32, seed 0, serving ``prompts`` greedily (one
    slot a prompt; a paged stack from blocks of BS): its streams and
    record; the model freed after."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    model, params, rec = family_model(torch, dev, name, "float32",
                                      depth=depth)
    t0 = time.perf_counter()
    kw = dict(block_size=BS) if model.supports_paged_kv() else {}
    eng = LPUEngine(model, params, EngineConfig(
        slots=len(prompts), max_seq=max_seq, **kw), device=dev,
        graphs=graphs)
    want = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize(dev)
    on_graphs(eng)
    rec.update(serve_s=time.perf_counter() - t0,
               tokens_per_s=eng.stats.tokens_per_s)
    del eng, model, params
    free_cuda(torch)
    return want, rec


# ---------------------------------------------------------------------------
# phase 14: the ring on its own cards (NCCL, a card per rank, graphs)
# ---------------------------------------------------------------------------

TP_CARDS = (2, 4)
# (a)'s runs: (key, ESL overlap, the engine's other knobs), each on
# graphs and, at tp 2, as an eager twin
CARDS_A_RUNS = (("overlap", True, {}), ("blocking", False, {}),
                ("blocking_chunks64", False,
                 {"prefill_chunk": PREFILL_CHUNK}))
# phase 13's collectives over (h1)'s traffic at tp 2 (gloo, two ranks on
# one H100 80GB HBM3): the same code on NCCL must count the same.
# Blocking's count there held its one-time gathers of the norm vectors,
# biases and position table (``dist.all_gather_param``), which phase 14
# makes in a warm-up: they are added back (``ring._gathered``)
PHASE13_COLLECTIVES = {"overlap": 13922, "blocking": 3755}
PHASE13_DECODE_STEPS = 62
GPT3_OUT = 256                 # (b): 32 in, 256 out, batch 1
OPT66_OUT = {"overlap": PAPER_OUT_TOKENS, "blocking": 512}
# the paper's figures, copied from benchmarks/paper_constants.py
# (PAPER_LATENCY, PAPER_BW_UTIL, PAPER_GPU_BW_UTIL, PAPER_SPEEDUP_VS_GPU
# at ("opt-66b", 2); PAPER_LPU_SCALING_PER_DOUBLING and
# PAPER_DGX_SCALING_PER_DOUBLING of Fig. 7c): printed beside the port's
PAPER_OPT66 = {"devices": 2, "lpu_ms_per_token": 22.2,
               "lpu_bandwidth_use": 0.906, "gpu_bandwidth_use": 0.649,
               "gpu_slower_x": 1.37}
PAPER_SCALING = {"lpu_per_doubling": 1.75, "dgx_per_doubling": 1.38}
# (d): kernel 1 at the ranks' heads (MHA, dh 128, bf16 pool, B 1): the
# protocol's mean length for each model's output
TP_CARDS_K1 = (("opt-66b", 36, PAPER_IN_TOKENS + PAPER_OUT_TOKENS // 2),
               ("opt-66b", 18, PAPER_IN_TOKENS + PAPER_OUT_TOKENS // 2),
               ("gpt3-20b", 24, PAPER_IN_TOKENS + GPT3_OUT // 2),
               ("gpt3-20b", 12, PAPER_IN_TOKENS + GPT3_OUT // 2))


def smi_query(*args):
    """nvidia-smi's output for ``args``, or the error that kept it."""
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def free_cuda(torch):
    """Collect and empty the allocator's cache, keeping its peak (unlike
    :func:`free_card`, which also checks that nothing is held: here a
    rank's shard stays between its runs)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def ring_gap(torch, ring, model, params, tokens):
    """(top-2 gap, top-1 logit) of the logits that pick the last of
    ``tokens``, from the ring model's own prefill of the ones before it
    (every rank calls it alike; the vocab columns gathered whole)."""
    row = top_picks(torch, model, params, tokens[:-1], tokens[-1:], ring,
                    k=2)[0]
    return row[0][1] - row[1][1], row[0][1]


def ring_agree(torch, ring, model, params, prompts, got, want, tol, what):
    """Greedy streams ``got`` and ``want`` equal, or first apart (within
    the shorter) where the ring model's top-2 gap is at most ``tol``: a
    near tie, where another order of f32 sums may pick either token.
    Every rank calls it on the same streams.  Raises otherwise."""
    out = []
    for i, (p, x, y) in enumerate(zip(prompts, got, want)):
        at = next((j for j, (u, v) in enumerate(zip(x, y)) if u != v), None)
        if at is None:
            continue
        gap, top = ring_gap(torch, ring, model, params,
                            list(p) + list(x[:at + 1]))
        if gap > tol:
            raise AssertionError(f"{what}: stream {i} differs at token {at} "
                                 f"where the top-2 gap is {gap} > {tol} "
                                 f"(top-1 logit {top})")
        out.append({"request": i, "at": at, "top2_gap": gap,
                    "top1_logit": top})
    return {"equal": len(prompts) - len(out), "of": len(prompts),
            "diverged_at_near_ties": out}


# a bf16 stream's picks kept for the near-tie test: each row's top 8
TIE_TOP_K = 8


def top_picks(torch, model, params, prompt, stream, ring=None,
              k=TIE_TOP_K):
    """For each token of ``stream``: the top ``k`` [token, logit] of the
    logits that pick it, from one prefill of ``prompt`` + ``stream[:-1]``
    by ``model`` (one card, or the ring ``ring``: every rank calls it
    alike, the vocab columns gathered whole)."""
    from repro_torch.core import esl
    from repro_torch.core.dist import make_axis_env
    dev = model.device
    tokens = list(prompt) + list(stream[:-1])
    S = len(tokens)
    env = None if ring is None else make_axis_env(model.plan, ring=ring)
    with torch.no_grad():
        lg, _ = model.forward(params, torch.tensor([tokens], device=dev),
                              mode="prefill", cache=model.init_cache(1, S),
                              positions=torch.arange(S, device=dev)[None],
                              env=env)
        rows = lg[0, len(prompt) - 1:].float()
        del lg
        if ring is not None:
            rows = esl.gather_scattered(rows, axis=ring, tp=ring.size)
        v, i = rows.topk(k, -1)
    return [[list(p) for p in zip(a, b)] for a, b in zip(i.tolist(),
                                                         v.tolist())]


def ring_agree_bf16(torch, ring, model, params, prompt, got, want, what,
                    tol=TOL["bfloat16"]):
    """A bf16 stream ``got`` of the ring against ``want`` = {"stream",
    "picks"} (another ring's or tp=1's, with its :func:`top_picks`):
    equal, or first apart (within the shorter) at a near tie seen from
    both sides: the two tokens each within tol + tol x |top-1 logit|
    (the reference's bf16 allclose, atol = rtol = 3e-2, at the top
    logit's scale) of the top of the ring model's own row and of the
    other side's row.  Every rank calls it alike.  Raises otherwise."""
    at = next((j for j, (u, v) in enumerate(zip(got, want["stream"]))
               if u != v), None)
    if at is None:
        return {"equal": 1, "of": 1, "diverged_at_near_ties": []}
    pair = (got[at], want["stream"][at])
    rec = {"at": at, "tokens": list(pair)}
    for side, row in (("ring", top_picks(torch, model, params, prompt,
                                         got[:at + 1], ring)[-1]),
                      ("other", want["picks"][at])):
        # how far each token lies below the row's top (inf outside its
        # top k)
        top, logit = row[0][1], dict(row)
        lags = [top - logit[t] if t in logit else math.inf for t in pair]
        bound = tol + tol * abs(top)
        rec[side] = {"lags": lags, "bound": bound, "top1_logit": top}
        if max(lags) > bound:
            raise AssertionError(
                f"{what}: stream differs at token {at} ({pair[0]} here, "
                f"{pair[1]} there), not a near tie of the {side} side's "
                f"logits: lags {lags} below its top > {bound}")
    return {"equal": 0, "of": 1, "diverged_at_near_ties": [rec]}


def ring_counts(ring, steps):
    """The ring's counters over a run of ``steps`` decode steps; on NCCL
    nothing may have been staged through the host."""
    c = ring.counters
    steps = max(steps, 1)
    if ring.nccl and c["staged_bytes"]:
        raise AssertionError(f"(14) {c['staged_bytes']} bytes staged "
                             "through the host on NCCL")
    return {"collectives": c["collectives"], "hops": c["hops"],
            "staged_bytes": c["staged_bytes"],
            "collectives_per_decode_step": c["collectives"] / steps,
            "hops_per_decode_step": c["hops"] / steps,
            "seconds_in_collective_calls": c["seconds"]}


def cards_opt13(torch, ring, spec):
    """(a) at this rank: full-width opt-1.3b (f32) with (h1)'s traffic in
    ESL overlap, in blocking and in blocking with a prefill in chunks of
    PREFILL_CHUNK, on graphs, and (tp 2) their eager twins;
    each engine warmed by one short request first (the process's first
    uses, and blocking's one-time parameter gathers), its counters read
    from zero over the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    dev = ring.device
    cfg = get_config("opt-1.3b")
    plans = ring_plans(cfg, ring.size)
    params = rank_weights(cfg, plans[True], ring.rank, dev)
    prompts, want = spec["prompts"], spec["want"]
    out = {}
    for key, overlap, graphs, knobs in spec["runs"]:
        what = f"(14a) opt-1.3b tp {ring.size} {key} rank {ring.rank}"
        model = build_model(cfg, plans[overlap], dev)
        eng = LPUEngine(model, params, EngineConfig(
            slots=4, max_seq=512, block_size=BS, **knobs), mesh=ring,
            device=dev, graphs=graphs)
        eng.generate(prompts[:1], max_new_tokens=2)
        torch.cuda.synchronize()
        eng.stats = type(eng.stats)()
        paged_decode_attention.launches = 0
        ring.reset_counters()
        t0 = time.perf_counter()
        streams = eng.generate(prompts, max_new_tokens=TP_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = paged_decode_attention.launches
        st = eng.stats
        rec = dict(run_rec(eng, launches), wall_s=wall,
                   tokens_per_s=st.tokens / wall, graphs=graphs,
                   kernel1_want=launches_want(eng),
                   **ring_counts(ring, st.device_decode_steps),
                   params_gathered_once=len(ring._gathered))
        if launches != rec["kernel1_want"] or not launches:
            raise AssertionError(f"{what}: kernel 1 launches {launches} != "
                                 f"{rec['kernel1_want']}")
        if graphs and not st.graph_replays:
            raise AssertionError(f"{what}: no replay")
        if bool(st.prefill_chunks) != ("prefill_chunk" in knobs):
            raise AssertionError(f"{what}: {st.prefill_chunks} prefill "
                                 "chunks")
        on_graphs(eng)
        pool_checks(eng, what)
        del eng
        rec["vs_tp1"] = ring_agree(torch, ring, model, params, prompts,
                                   streams, want, CHAIN_TOL, what)
        rec["streams"] = streams
        out[key] = rec
        del model
    del params
    free_cuda(torch)
    return out


def cards_protocol(torch, ring, spec):
    """(b) and (c) at this rank: ``spec["name"]`` at full width in bf16,
    this rank's shard drawn alone, through the paper's protocol
    (:func:`protocol_run`: batch 1, 32 in, ``out`` new tokens, on
    graphs) in each mode of ``spec["out"]``; the ring's counters, peak
    memory, bytes a card reads a token, and each stream against
    ``spec["want"]`` (tp=1's or another ring's stream with its picks)
    or, with none, against the first mode's, apart only at a bf16 near
    tie seen from both sides (:func:`ring_agree_bf16`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    dev = ring.device
    name = spec["name"]
    cfg = get_config(name)
    plans = ring_plans(cfg, ring.size, "bfloat16")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = rank_weights(cfg, plans[True], ring.rank, dev)
    torch.cuda.synchronize()
    out = {"setup_s": time.perf_counter() - t0,
           "weight_bytes_per_card": weight_bytes(params),
           "peak_memory_after_draw": torch.cuda.max_memory_allocated(dev),
           "runs": {}}
    prompt = protocol_prompt(cfg)
    want, peak = spec.get("want"), 0
    for key, out_n in spec["out"].items():
        what = f"(14) {name} tp {ring.size} {key} rank {ring.rank}"
        model = build_model(cfg, plans[key == "overlap"], dev)
        r = protocol_run(torch, dev, model, params, prompt, out_n, True,
                         mesh=ring)
        # the serving peak, before the near-tie test's prefills
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
        free_cuda(torch)
        r.update(r.pop("ring"), out_tokens=len(r["out"]))
        a = model.plan.attn
        mean_len = PAPER_IN_TOKENS + len(r["out"]) / 2
        kv = 2 * cfg.n_layers * a.kv_per_rank * a.d_head * 2 * mean_len
        per_tok = out["weight_bytes_per_card"] + kv
        bw = bandwidth_for(torch.cuda.get_device_name(dev))
        r.update(mean_length=mean_len, kv_bytes_per_card=kv,
                 bytes_per_card_per_token=per_tok,
                 bound_ms_per_token=per_tok / bw * 1e3,
                 bandwidth_use_wall=per_tok / (r["wall_ms_per_token"] / 1e3)
                 / bw,
                 bandwidth_use_device=per_tok
                 / (r["device_ms_per_token"] / 1e3) / bw)
        got = r.pop("out")
        if want is None:
            # the first mode's stream is what the others are held to
            # (and, from tp 2's ring, what tp 4's is held to)
            want = {"stream": got, "picks": top_picks(
                torch, model, params, prompt, got, ring)}
            out["picks"] = want["picks"]
        else:
            r["vs_want"] = ring_agree_bf16(torch, ring, model, params,
                                           prompt, got, want, what)
        r["stream"] = got
        out["runs"][key] = r
        del model
        free_cuda(torch)
    out["peak_memory_bytes"] = peak
    del params
    free_cuda(torch)
    return out


def tp_cards_rank(ring, spec):
    """One rank of phase 14 (rank r on ``cuda:r``, NCCL): (a), (b) and
    (c) in turn, each model freed before the next; returns every rank's
    record."""
    import torch
    out = {"rank": ring.rank, "device": str(ring.device),
           "card": torch.cuda.get_device_name(ring.device),
           "backend": ring.backend}
    t0 = time.perf_counter()
    out["a"] = cards_opt13(torch, ring, spec["a"])
    out["a_s"] = time.perf_counter() - t0
    if ring.rank == 0:
        # rank 0's figures as they come, should a later part fail
        print(f"[tp_cards] (14a) tp {ring.size} rank 0: " + ", ".join(
            f"{k} {r['tokens_per_s']:.1f} tokens/s, {r['collectives']} "
            f"collectives, {r['graph_replays']} replays"
            for k, r in out["a"].items()), flush=True)
    for part in ("b", "c"):
        t0 = time.perf_counter()
        out[part] = cards_protocol(torch, ring, spec[part])
        out[f"{part}_s"] = time.perf_counter() - t0
        if ring.rank == 0:
            print(f"[tp_cards] (14{part}) tp {ring.size} rank 0: " + ", ".join(
                f"{k} {r['wall_ms_per_token']:.3f} ms/token wall, "
                f"{r['device_ms_per_token']:.3f} device"
                for k, r in out[part]["runs"].items()), flush=True)
    return ring.gather_object(out)


def same_on_ranks(per_rank, get, what):
    vals = [get(r) for r in per_rank]
    if any(v != vals[0] for v in vals):
        raise AssertionError(f"(14) {what}: the ranks differ")
    return vals[0]


def run_tp_cards(torch, dev, card_name, lap=None):
    """Phase 14 on a machine of 2 or more cards: the topology, (d) kernel
    1 at the ranks' heads on cuda:0, the tp=1 references on cuda:0
    (opt-1.3b f32 with (h1)'s traffic; GPT3-20B bf16 through the
    protocol, 256 new), then a ring of 2 and of 4 ranks, each on its own
    card over NCCL, every step on graphs: (a) opt-1.3b, (b) GPT3-20B,
    (c) opt-66b (tp 4 held to tp 2's stream).  Returns the record."""
    from repro_torch.core.dist import run_ranks
    n = torch.cuda.device_count()
    t_phase = time.perf_counter()
    rec = {"cards": n, "card": card_name,
           "cards_listed": smi_query("--query-gpu=index,name,power.limit",
                                     "--format=csv,noheader").splitlines(),
           "topology": smi_query("topo", "-m"),
           "nvlink": smi_query("nvlink", "--status"),
           "peer_access": [[i == j or torch.cuda.can_device_access_peer(i, j)
                            for j in range(n)] for i in range(n)]}
    print(f"[tp_cards] (14) {n} cards:\n" + "\n".join(rec["cards_listed"])
          + f"\n{rec['topology']}\n{rec['nvlink'][:1500]}\npeer access "
          f"{rec['peer_access']}", flush=True)

    t0 = time.perf_counter()
    rec["d_kernel1"] = {f"{m}/{h}heads": check_time_paged_opt(
        torch, dev, card_name, heads=h, dhs=(128,), length=ln,
        what="(14d)")["dh128"] for m, h, ln in TP_CARDS_K1}
    rec["d_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model, params = opt_model(torch, dev, "opt-1.3b")
    prompts = opt_prompts(model.cfg)[0]
    opt1, eng, _ = serve(torch, dev, model, params, prompts, block_size=BS)
    del eng, model, params
    free_cuda(torch)
    model, params = opt_model(torch, dev, "gpt3-20b", "bfloat16")
    gprompt = protocol_prompt(model.cfg)
    g1 = protocol_run(torch, dev, model, params, gprompt, GPT3_OUT, True)
    g1["weight_bytes"] = weight_bytes(params)
    free_cuda(torch)
    stream = g1.pop("out")
    gpt3 = {"stream": stream, "picks": top_picks(torch, model, params,
                                                 gprompt, stream)}
    del model, params
    free_cuda(torch)
    rec["tp1_s"] = time.perf_counter() - t0
    rec["b_tp1"] = g1

    opt66 = None
    for tp in TP_CARDS:
        if n < tp:
            rec[f"tp{tp}"] = f"not run: {n} cards"
            continue
        runs = [(key + "_eager" * (not graphs), overlap, graphs, knobs)
                for graphs in (True, False)[:1 + (tp == 2)]
                for key, overlap, knobs in CARDS_A_RUNS]
        spec = {"a": {"prompts": prompts, "want": opt1, "runs": runs},
                "b": {"name": "gpt3-20b", "want": gpt3,
                      "out": {"overlap": GPT3_OUT, "blocking": GPT3_OUT}},
                "c": {"name": "opt-66b", "want": opt66, "out": OPT66_OUT}}
        t0 = time.perf_counter()
        # a collective that waits 300 s for a peer has hung: fail then
        per_rank = run_ranks(tp_cards_rank, tp, spec, device="cuda",
                             placement="card_per_rank", timeout_s=300)
        r = {"ranks_s": time.perf_counter() - t0,
             "backend": same_on_ranks(per_rank, lambda x: x["backend"],
                                      "backend"),
             "rank_cards": [x["card"] for x in per_rank],
             "part_s": [{p: x[f"{p}_s"] for p in "abc"} for x in per_rank]}
        a = {}
        for key, *_ in runs:
            rr = [x["a"][key] for x in per_rank]
            same_on_ranks(rr, lambda x: x["streams"], f"(a) {key} streams")
            a[key] = dict({k: v for k, v in rr[0].items()
                           if k != "streams"},
                          kernel1_launches_per_rank=[
                              x["kernel_launches"] for x in rr],
                          wall_s_per_rank=[x["wall_s"] for x in rr])
        for mode, *_ in CARDS_A_RUNS if tp == 2 else ():
            g, e = a[mode], a[f"{mode}_eager"]
            if g["collectives"] != e["collectives"] or \
                    g["hops"] != e["hops"]:
                raise AssertionError(
                    f"(14a) {mode}: graphs {g['collectives']} "
                    f"collectives / {g['hops']} hops, eager twin "
                    f"{e['collectives']} / {e['hops']}")
            if mode in PHASE13_COLLECTIVES:
                made = g["collectives"] + (g["params_gathered_once"]
                                           if mode == "blocking" else 0)
                g["vs_phase13"] = {
                    "phase13_collectives": PHASE13_COLLECTIVES[mode],
                    "phase13_per_decode_step": PHASE13_COLLECTIVES[mode]
                    / PHASE13_DECODE_STEPS,
                    "collectives_with_one_time_gathers": made}
                if made != PHASE13_COLLECTIVES[mode] or \
                        g["device_decode_steps"] != PHASE13_DECODE_STEPS:
                    raise AssertionError(
                        f"(14a) {mode}: {made} collectives over "
                        f"{g['device_decode_steps']} decode steps, phase 13 "
                        f"counted {PHASE13_COLLECTIVES[mode]} over "
                        f"{PHASE13_DECODE_STEPS}")
        r["a"] = a
        for part in ("b", "c"):
            rr = [x[part] for x in per_rank]
            m = {"setup_s": [x["setup_s"] for x in rr],
                 "weight_bytes_per_card": [x["weight_bytes_per_card"]
                                           for x in rr],
                 "peak_memory_bytes_per_card": [x["peak_memory_bytes"]
                                                for x in rr],
                 "peak_memory_after_draw_per_card": [
                     x["peak_memory_after_draw"] for x in rr],
                 "runs": {}}
            for key in rr[0]["runs"]:
                runs_k = [x["runs"][key] for x in rr]
                stream = same_on_ranks(runs_k, lambda x: x["stream"],
                                       f"({part}) {key} stream")
                one = {k: v for k, v in runs_k[0].items()
                       if k not in ("stream", "eager_twin", "ttft",
                                    "top_kernels")}
                for k in ("wall_ms_per_token", "device_ms_per_token",
                          "bandwidth_use_wall", "bandwidth_use_device"):
                    one[f"{k}_per_rank"] = [x[k] for x in runs_k]
                one["nccl_ms_per_token_per_rank"] = [
                    x["profiled_window"]["nccl_ms_per_token"]
                    for x in runs_k]
                one["ttft_ms_rank0"] = runs_k[0]["ttft"]["ttft_ms"]
                one["top_kernels_rank0"] = runs_k[0]["top_kernels"]
                one["stream_head"] = stream[:16]
                m["runs"][key] = one
                if part == "c" and tp == 2 and key == "overlap":
                    opt66 = {"stream": stream, "picks": rr[0]["picks"]}
            r[part] = m
        rec[f"tp{tp}"] = r
        if lap is not None:
            lap(f"(14) tp {tp}")
    b_ms = {1: {"overlap": g1["wall_ms_per_token"]}}
    b_dev = {1: {"overlap": g1["device_ms_per_token"]}}
    for tp in TP_CARDS:
        if isinstance(rec.get(f"tp{tp}"), dict):
            b_ms[tp] = {k: max(v["wall_ms_per_token_per_rank"])
                        for k, v in rec[f"tp{tp}"]["b"]["runs"].items()}
            b_dev[tp] = {k: max(v["device_ms_per_token_per_rank"])
                         for k, v in rec[f"tp{tp}"]["b"]["runs"].items()}
    scaling = {}
    for mode in ("overlap", "blocking"):
        prev = 1
        for tp in sorted(b_ms)[1:]:
            base = b_ms[prev].get(mode, b_ms[prev]["overlap"])
            dbase = b_dev[prev].get(mode, b_dev[prev]["overlap"])
            scaling[f"{mode} tp{prev}->tp{tp}"] = {
                "wall": base / b_ms[tp][mode],
                "device": dbase / b_dev[tp][mode]}
            prev = tp
    rec["b_scaling_per_doubling"] = dict(
        scaling, paper=dict(PAPER_SCALING,
                            source="benchmarks/paper_constants.py (the "
                                   "paper's figures, not the port's)"))
    rec["c_paper"] = dict(PAPER_OPT66, source="benchmarks/paper_constants"
                          ".py (the paper's figures, not the port's)")
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def print_tp_cards(rec, smi):
    """The phase's summary lines."""
    for tp in TP_CARDS:
        r = rec.get(f"tp{tp}")
        if not isinstance(r, dict):
            print(f"[tp_cards] (14) tp {tp}: {r}")
            continue
        for k, x in r["a"].items():
            print(f"[tp_cards] (14a) opt-1.3b tp {tp} {k}: {x['tokens']} "
                  f"tokens in {x['wall_s']:.2f} s ({x['tokens_per_s']:.1f} "
                  f"tok/s), {x['collectives_per_decode_step']:.1f} "
                  f"collectives and {x['hops_per_decode_step']:.1f} hops a "
                  f"decode step, staged {x['staged_bytes']}, replays "
                  f"{x['graph_replays']}, kernel 1 "
                  f"{x['kernel1_launches_per_rank']} (want "
                  f"{x['kernel1_want']}), equal to tp=1 "
                  f"{x['vs_tp1']['equal']}/{x['vs_tp1']['of']} | {smi}")
        for part, name in (("b", "gpt3-20b"), ("c", "opt-66b")):
            m = r[part]
            for k, x in m["runs"].items():
                print(f"[tp_cards] (14{part}) {name} tp {tp} {k}: "
                      f"{x['out_tokens']} tokens, ms/token wall "
                      f"{x['wall_ms_per_token_per_rank']} device "
                      f"{x['device_ms_per_token_per_rank']} (NCCL "
                      f"{x['nccl_ms_per_token_per_rank']}), bound "
                      f"{x['bound_ms_per_token']:.3f}, bandwidth use "
                      f"{x['bandwidth_use_wall_per_rank']}, "
                      f"{x['collectives_per_decode_step']:.1f} collectives "
                      f"a token | {smi}")
            print(f"[tp_cards] (14{part}) {name} tp {tp}: peak memory per "
                  f"card {m['peak_memory_bytes_per_card']}, weights per "
                  f"card {m['weight_bytes_per_card']}, draw "
                  f"{m['setup_s']} s")
    print(f"[tp_cards] (14b) gpt3-20b speed-up per doubling: "
          f"{rec['b_scaling_per_doubling']}")
    for k, x in rec["d_kernel1"].items():
        print(f"[tp_cards] (14d) kernel 1 at {k}: {x['ms']:.5f} ms (bound "
              f"{x['bound_ms']:.6f} by {x['bound_by']}, plain "
              f"{x['plain_ms']:.4f}, library {x['library_ms']:.4f}), max "
              f"abs {x['max_abs_err']}")
    print(f"[time] (14) tp_cards {rec['phase_s']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 15: rwkv, mamba and the MoE over the ring on cards of their own
# ---------------------------------------------------------------------------

FAM_TP = 2
FAM_JAMBA_DEPTH = 32           # (a): jamba-v0.1-52b whole
FAM_JAMBA_OUT = 256            # (a): batch 1, 32 in, 256 out
FAM_EAGER_TOKENS = 16          # (a): the eager twin's first tokens
FAM_BATCH = (4, 32)            # (a): 4 prompts x 32 new at 4 slots
FAM_PROFILE_STEPS = 32         # (a): decode steps under torch.profiler
FAM_MAX_SEQ = 512
FAM_B_DEPTH = 8                # (b): jamba, one super-block
FAM_B_NEW = 16
FAM_RWKV_NEW = 16              # (c) and (d): 4 prompts x 16 new
FAM_GRANITE_DEPTH = 16
# (e): the scans at the ranks' shapes: rwkv6-7b's 64 heads of 64 and
# jamba's 8192 channels of 16 states over 2 and 4 ranks, 1 and 4 rows
FAM_SCAN_SHAPES = {
    "rwkv_scan": [(b, 1, 64 // tp, 64) for tp in (2, 4) for b in (1, 4)],
    "mamba_scan_fused": [(b, 1, 8192 // tp, 16) for tp in (2, 4)
                         for b in (1, 4)]}


def check_time_rank_scans(torch, dev, card_name):
    """(e): kernels 4 and 5 (the fused entry) at the ranks' shapes on
    ``dev``: against their plain versions (bit-equal, as at tp=1) and
    timed beside them, with the bound of each call."""
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_fused_ref
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref
    out = {}
    for name, kernel, plain, inputs, bound in (
            ("rwkv_scan", rwkv_scan, rwkv_scan_ref, rwkv_inputs,
             rwkv_bound),
            ("mamba_scan_fused", mamba_scan_fused, mamba_scan_fused_ref,
             mamba_fused_inputs, mamba_fused_bound)):
        for shape in FAM_SCAN_SHAPES[name]:
            args = inputs(torch, dev, shape, 90)
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize(dev)
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            if not exact:
                raise AssertionError(f"(15e) {name} {shape}: not bit-equal "
                                     f"to its plain version (max abs {err})")
            per_set = 4 * sum(a.numel() for a in args)
            sets = [tuple(a.clone() for a in args)
                    for _ in range(sets_for(per_set))]
            t = timed(torch, {"ms": lambda i: kernel(*sets[i]),
                              "plain_ms": lambda i: plain(*sets[i])},
                      len(sets))
            t["bound_ms"], t["bound_by"] = bound(shape, card_name)
            t.update(max_abs_err=err, bit_equal=exact, shape=list(shape),
                     library_ms=None)
            out[f"{name} {'x'.join(map(str, shape))}"] = t
            del sets, args
    return out


def fam_cfg(name, depth=None):
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg, n_layers=depth) if depth else cfg


def ring_engine_run(torch, ring, model, params, prompts, new, graphs,
                    slots=None, max_seq=None, knobs=None):
    """``prompts`` served greedily by this rank's engine on the ring (a
    warm-up request first; ``knobs``: the engine's other settings, e.g.
    a drafter), the family kernel's launches and the ring's counters
    from zero over the run: -> (streams, record)."""
    from repro_torch.launch.serve import family_kernel
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    cfg, dev = model.cfg, ring.device
    kernel = family_kernel(cfg)
    kw = dict(block_size=BS) if model.supports_paged_kv() else {}
    eng = LPUEngine(model, params, EngineConfig(
        slots=slots or len(prompts), max_seq=max_seq or FAM_MAX_SEQ,
        **kw, **(knobs or {})), mesh=ring, device=dev,
        graphs=graphs and ring.nccl)
    eng.generate(prompts[:1], max_new_tokens=2)
    torch.cuda.synchronize(dev)
    eng.stats = type(eng.stats)()
    if eng.drafter is not None:
        from repro_torch.serving.drafter import ProposalLog
        eng.drafter = ProposalLog(eng.drafter)
    kernel.launches = 0
    ring.reset_counters()
    t0 = time.perf_counter()
    streams = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    st = eng.stats
    launches = kernel.launches
    if kernel.__name__ == "paged_decode_attention":
        want = launches_want(eng)
    elif cfg.family == "rwkv":
        want = cfg.n_layers * st.device_decode_steps
    else:
        want = n_scan_layers(cfg) * (st.device_decode_steps + st.prefills)
    what = f"(15) {cfg.name} tp {ring.size} rank {ring.rank}"
    if launches != want or not launches:
        raise AssertionError(f"{what}: {kernel.__name__} launches "
                             f"{launches} != {want}")
    on_graphs(eng)
    if eng.graphs and not st.graph_replays:
        raise AssertionError(f"{what}: no replay")
    if eng.paged:
        eng.check_pool_balanced()
    if eng.drafter is not None:
        if not st.spec_rounds:
            raise AssertionError(f"{what}: no verify round")
        launches_by = {"verify_replays": eng._programs.replays_of("verify")}
    else:
        launches_by = {}
    rec = dict(run_rec(eng, launches), wall_s=wall, graphs=eng.graphs,
               kernel=kernel.__name__, kernel_want=want, **launches_by,
               **(spec_counts(eng) if eng.drafter is not None else {}),
               cache_shapes={lj: {k: list(v.shape) for k, v in c.items()}
                             for lj, c in eng.cache.items()},
               **ring_counts(ring, st.device_decode_steps))
    del eng
    return streams, rec


def ring_decode_protocol(torch, ring, model, params, prompt, out_n):
    """(a) at this rank: one request of ``out_n`` new tokens at batch 1
    on captured windows (8-step, max_seq FAM_MAX_SEQ), after a warm-up
    request that captures them; FAM_PROFILE_STEPS decode steps in the
    middle under torch.profiler give device ms per token (NCCL's
    kernels apart), the engine's clock over the rest wall ms per token;
    kernel 5's launches counted from zero over the request; then the
    eager twin's first FAM_EAGER_TOKENS tokens of the same request."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import family_kernel
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    cfg, dev = model.cfg, ring.device
    kernel = family_kernel(cfg)
    conf = EngineConfig(slots=1, max_seq=FAM_MAX_SEQ,
                        steps_per_sync=OPT_WINDOW)
    eng = LPUEngine(model, params, conf, device=dev, graphs=ring.nccl,
                    mesh=ring)
    eng.generate([prompt], max_new_tokens=2 * OPT_WINDOW)       # warm
    torch.cuda.synchronize(dev)
    kernel.launches = 0
    ring.reset_counters()
    st = eng.stats
    base = dataclasses.replace(st)
    rid = eng.submit(prompt, out_n)
    mid = len(prompt) + out_n // 2 - FAM_PROFILE_STEPS // 2
    seq = None
    while seq is None or seq.pos < mid:
        eng.step()
        seq = eng.sched.active[0]
    steps0, wall0 = st.device_decode_steps, st.wall
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while st.device_decode_steps - steps0 < FAM_PROFILE_STEPS and \
                eng.sched.has_work():
            eng.step()
        torch.cuda.synchronize(dev)
    steps = st.device_decode_steps - steps0
    window_wall = st.wall - wall0
    out = eng.drain()[rid]
    torch.cuda.synchronize(dev)
    dsteps = st.device_decode_steps - base.device_decode_steps
    prefills = st.prefills - base.prefills
    want = n_scan_layers(cfg) * (dsteps + prefills)
    what = f"(15a) {cfg.name} tp {ring.size} rank {ring.rank}"
    launches = kernel.launches
    if launches != want or not want:
        raise AssertionError(f"{what}: {kernel.__name__} launches "
                             f"{launches} != {want}")
    replays = st.graph_replays - base.graph_replays
    if bool(replays) != eng.graphs or \
            st.graph_captures != base.graph_captures:
        raise AssertionError(f"{what}: {replays} replays, "
                             f"{st.graph_captures - base.graph_captures} "
                             "captures while measured")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us or not steps:
        raise AssertionError(f"{what}: the profiler saw {busy_us} us over "
                             f"{steps} decode steps")
    device_ms = busy_us / 1e3 / steps
    nccl_ms = sum(e.self_device_time_total for e in kernels
                  if "nccl" in e.key.lower()) / 1e3 / steps
    wall_ms = (st.wall - base.wall - window_wall) * 1e3 / (len(out) - steps)
    counts = ring_counts(ring, dsteps)
    # a step reads and writes every recurrent state (conv, ssm); the
    # attention layers' K/V at these lengths (< 2 MB a card) left out
    state = 2 * sum(t.numel() * t.element_size()
                    for c in eng.cache.values() if "ssm" in c
                    for t in c.values())
    del eng
    free_cuda(torch)
    twin = LPUEngine(model, params, conf, device=dev, graphs=False,
                     mesh=ring)
    eager = twin.generate([prompt], max_new_tokens=FAM_EAGER_TOKENS)[0]
    torch.cuda.synchronize(dev)
    del twin
    if eager != out[:FAM_EAGER_TOKENS]:
        raise AssertionError(f"{what}: the eager twin's first "
                             f"{FAM_EAGER_TOKENS} tokens {eager} != "
                             f"{out[:FAM_EAGER_TOKENS]}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"out": out, "wall_ms_per_token": wall_ms,
            "device_ms_per_token": device_ms, "nccl_ms_per_token": nccl_ms,
            "device_busy_share": device_ms / wall_ms,
            "profiled_decode_steps": steps, "decode_steps": dsteps,
            "prefills": prefills, "kernel5_launches": launches,
            "state_bytes_per_step": state,
            "kernel5_want": want, "graph_replays": replays,
            "eager_twin_equal_tokens": len(eager), **counts,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def expert_bytes(params):
    return sum(t.numel() * t.element_size() for path, t in
               _paths(params) if "/moe/w" in path)


def _paths(tree, pre=""):
    for k, v in tree.items():
        p = f"{pre}/{k}" if pre else k
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p, v


def fam_a(torch, ring, spec):
    """(a) at this rank: jamba-v0.1-52b whole in bf16, this rank's shard
    drawn alone; in ESL overlap and in blocking the protocol (batch 1,
    32 in, FAM_JAMBA_OUT out) and FAM_BATCH's batch on 4 slots, both on
    graphs; the blocking stream held to the overlap stream by the
    two-sided bf16 near-tie rule; peak memory per card."""
    from repro_torch.models.registry import build_model
    from repro_torch.weights import init_shard
    dev = ring.device
    cfg = fam_cfg("jamba-v0.1-52b", spec["depth"])
    plans = ring_plans(cfg, ring.size, "bfloat16")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_shard(cfg, plans[True], ring.rank, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    wb, eb = tree_bytes(params), expert_bytes(params)
    rec = {"setup_s": time.perf_counter() - t0, "weight_bytes": wb,
           "expert_bytes": eb,
           "peak_memory_after_draw": torch.cuda.max_memory_allocated(dev),
           "runs": {}}
    prompt = protocol_prompt(cfg)
    bw = bandwidth_for(torch.cuda.get_device_name(dev))
    # at batch 1 the routing needs top_k experts of each MoE layer: the
    # worst card holds both
    ecell = plans[True].moe.n_experts // ring.size
    routed = wb - eb + eb * min(1.0, cfg.moe.top_k / ecell)
    first = None
    peak = 0
    for key in ("overlap", "blocking"):
        model = build_model(cfg, plans[key == "overlap"], dev)
        r = ring_decode_protocol(torch, ring, model, params, prompt,
                                 spec["out"])
        step = wb + r["state_bytes_per_step"]
        r.update(bytes_per_step=step, bound_ms_per_token=step / bw * 1e3,
                 routed_bytes_per_step=routed + r["state_bytes_per_step"],
                 routed_bound_ms_per_token=(routed + r[
                     "state_bytes_per_step"]) / bw * 1e3,
                 bandwidth_use_device=step / (r["device_ms_per_token"] / 1e3)
                 / bw)
        got = r.pop("out")
        if first is None:
            first = got
        else:
            # reported, not gated: jamba in bf16 parts from itself under
            # another order of sums (PERF.md §6, PR 29)
            r["first_apart_from_overlap"] = next(
                (j for j, (u, v) in enumerate(zip(got, first)) if u != v),
                None)
        r["stream_head"] = got[:16]
        r["out_tokens"] = len(got)
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
        free_cuda(torch)
        prompts = family_prompts(cfg, FAM_BATCH[0], seed=15)
        streams, b = ring_engine_run(torch, ring, model, params, prompts,
                                     FAM_BATCH[1], True)
        b["streams_head"] = [x[:8] for x in streams]
        b["ms_per_decode_step"] = b["wall_s"] * 1e3 / max(
            b["device_decode_steps"], 1)
        r["batch4"] = b
        rec["runs"][key] = r
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
        del model
        free_cuda(torch)
        if ring.rank == 0:
            print(f"[tp_families] (15a) jamba tp {ring.size} {key} rank 0: "
                  f"{r['wall_ms_per_token']:.3f} ms/token wall, "
                  f"{r['device_ms_per_token']:.3f} device, bound "
                  f"{r['bound_ms_per_token']:.3f}", flush=True)
    rec["peak_memory_bytes"] = peak
    del params
    free_cuda(torch)
    return rec


def fam_vs_tp1(torch, ring, spec):
    """(b), (c), (d) at this rank: ``spec["name"]`` at ``spec["depth"]``
    in f32, this rank's shard drawn alone, serving the tp=1 run's
    prompts on graphs in ESL overlap; each stream against tp=1's, apart
    only at a top-2 gap <= CHAIN_TOL of the ring's model."""
    from repro_torch.models.registry import build_model
    from repro_torch.weights import init_shard
    dev = ring.device
    cfg = fam_cfg(spec["name"], spec["depth"])
    plan = ring_plans(cfg, ring.size)[True]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_shard(cfg, plan, ring.rank, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    setup = time.perf_counter() - t0
    model = build_model(cfg, plan, dev)
    prompts = spec["prompts"]
    streams, rec = ring_engine_run(torch, ring, model, params, prompts,
                                   spec["new"], True)
    rec["vs_tp1"] = ring_agree(torch, ring, model, params, prompts,
                               streams, spec["want"], CHAIN_TOL,
                               f"(15) {cfg.name} tp {ring.size} rank "
                               f"{ring.rank}")
    rec.update(setup_s=setup, weight_bytes=tree_bytes(params),
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
               streams=streams)
    del model, params
    free_cuda(torch)
    return rec


def tp_families_rank(ring, spec):
    """One rank of phase 15 (rank r on ``cuda:r``, NCCL): (a) to (d) in
    turn, each model freed before the next; returns every rank's
    record."""
    import torch
    out = {"rank": ring.rank, "device": str(ring.device),
           "card": torch.cuda.get_device_name(ring.device),
           "backend": ring.backend}
    for part in ("a", "b", "c", "d"):
        t0 = time.perf_counter()
        out[part] = (fam_a if part == "a" else fam_vs_tp1)(torch, ring,
                                                           spec[part])
        out[f"{part}_s"] = time.perf_counter() - t0
        if ring.rank == 0:
            print(f"[tp_families] (15{part}) rank 0 done in "
                  f"{out[f'{part}_s']:.1f} s", flush=True)
    return ring.gather_object(out)


def run_tp_families(torch, dev, card_name, lap=None,
                    placement="card_per_rank"):
    """Phase 15 on a machine of 2 or more cards: (e) kernels 4 and 5 at
    the ranks' shapes on cuda:0; the tp=1 references on cuda:0 (jamba
    one super-block, rwkv6-7b whole, granite at depth 16, all f32
    in f32), then a ring of FAM_TP ranks, each on its own card over
    NCCL, every step on graphs, each rank drawing only its shard: (a)
    jamba-v0.1-52b whole, (b) to (d) against their tp=1 references.
    ``placement="shared_card"`` rehearses the phase on one card (the
    ranks share it over gloo, steps eager)."""
    from repro_torch.core.dist import run_ranks
    t_phase = time.perf_counter()
    rec = {"card": card_name, "cards": torch.cuda.device_count(),
           "cards_listed": smi_query("--query-gpu=index,name,power.limit",
                                     "--format=csv,noheader").splitlines()}
    t0 = time.perf_counter()
    rec["e_scans"] = check_time_rank_scans(torch, dev, card_name)
    rec["e_s"] = time.perf_counter() - t0
    if lap is not None:
        lap("(15e) scans")
    t0 = time.perf_counter()
    b_cfg = fam_cfg("jamba-v0.1-52b", FAM_B_DEPTH)
    b_prompts = [protocol_prompt(b_cfg)] + family_prompts(b_cfg, 1, seed=16)
    b_want, rec["b_tp1"] = tp1_streams(torch, dev, "jamba-v0.1-52b",
                                       FAM_B_DEPTH, b_prompts, FAM_B_NEW,
                                       FAM_MAX_SEQ, True)
    c_cfg = fam_cfg("rwkv6-7b")
    c_prompts = family_prompts(c_cfg, 4, seed=17)
    c_want, rec["c_tp1"] = tp1_streams(torch, dev, "rwkv6-7b", None,
                                       c_prompts, FAM_RWKV_NEW, FAM_MAX_SEQ,
                                       True)
    d_cfg = fam_cfg("granite", FAM_GRANITE_DEPTH)
    d_prompts = family_prompts(d_cfg, 4, seed=18)
    d_want, rec["d_tp1"] = tp1_streams(torch, dev, "granite",
                                       FAM_GRANITE_DEPTH, d_prompts,
                                       FAM_RWKV_NEW, FAM_MAX_SEQ, True)
    rec["tp1_s"] = time.perf_counter() - t0
    if lap is not None:
        lap("(15) tp=1 references")
    spec = {"a": {"out": FAM_JAMBA_OUT, "depth": FAM_JAMBA_DEPTH},
            "b": {"name": "jamba-v0.1-52b", "depth": FAM_B_DEPTH,
                  "dtype": "float32", "prompts": b_prompts,
                  "new": FAM_B_NEW, "want": b_want},
            "c": {"name": "rwkv6-7b", "depth": None, "dtype": "float32",
                  "prompts": c_prompts, "new": FAM_RWKV_NEW,
                  "want": c_want},
            "d": {"name": "granite", "depth": FAM_GRANITE_DEPTH,
                  "dtype": "float32", "prompts": d_prompts,
                  "new": FAM_RWKV_NEW, "want": d_want}}
    t0 = time.perf_counter()
    per_rank = run_ranks(tp_families_rank, FAM_TP, spec, device="cuda",
                         placement=placement, timeout_s=300)
    rec["ranks_s"] = time.perf_counter() - t0
    rec["backend"] = same_on_ranks(per_rank, lambda x: x["backend"],
                                   "backend")
    rec["rank_cards"] = [x["card"] for x in per_rank]
    rec["part_s"] = [{p: x[f"{p}_s"] for p in "abcd"} for x in per_rank]
    a = [x["a"] for x in per_rank]
    ra = {"arch": "jamba-v0.1-52b", "dtype": "bfloat16",
          "n_layers": FAM_JAMBA_DEPTH, "tp": FAM_TP,
          "setup_s": [x["setup_s"] for x in a],
          "weight_bytes_per_card": [x["weight_bytes"] for x in a],
          "expert_bytes_per_card": [x["expert_bytes"] for x in a],
          "peak_memory_bytes_per_card": [x["peak_memory_bytes"] for x in a],
          "peak_memory_after_draw_per_card": [x["peak_memory_after_draw"]
                                              for x in a],
          "runs": {}}
    for key in a[0]["runs"]:
        rr = [x["runs"][key] for x in a]
        same_on_ranks(rr, lambda x: x["stream_head"], f"(15a) {key} stream")
        one = {k: v for k, v in rr[0].items()
               if k not in ("top_kernels", "batch4")}
        for k in ("wall_ms_per_token", "device_ms_per_token",
                  "nccl_ms_per_token", "kernel5_launches",
                  "bandwidth_use_device"):
            one[f"{k}_per_rank"] = [x[k] for x in rr]
        one["top_kernels_rank0"] = rr[0]["top_kernels"]
        bb = [x["batch4"] for x in rr]
        one["batch4"] = dict(
            {k: v for k, v in bb[0].items() if k != "streams_head"},
            kernel5_launches_per_rank=[x["kernel_launches"] for x in bb],
            ms_per_decode_step_per_rank=[x["ms_per_decode_step"]
                                         for x in bb],
            streams_head=same_on_ranks(bb, lambda x: x["streams_head"],
                                       f"(15a) {key} batch streams"))
        ra["runs"][key] = one
    rec["a"] = ra
    for part in "bcd":
        rr = [x[part] for x in per_rank]
        same_on_ranks(rr, lambda x: x["streams"], f"({part}) streams")
        rec[part] = dict(
            {k: v for k, v in rr[0].items() if k != "streams"},
            kernel_launches_per_rank=[x["kernel_launches"] for x in rr],
            peak_memory_bytes_per_card=[x["peak_memory_bytes"] for x in rr],
            weight_bytes_per_card=[x["weight_bytes"] for x in rr],
            setup_s=[x["setup_s"] for x in rr])
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def print_tp_families(rec, smi):
    """The phase's summary lines."""
    a = rec["a"]
    for k, x in a["runs"].items():
        b = x["batch4"]
        print(f"[tp_families] (15a) jamba-v0.1-52b {a['n_layers']} layers "
              f"bf16 tp {a['tp']} {k}: {x['out_tokens']} tokens, ms/token "
              f"wall {x['wall_ms_per_token_per_rank']} device "
              f"{x['device_ms_per_token_per_rank']} (NCCL "
              f"{x['nccl_ms_per_token_per_rank']}), bound "
              f"{x['bound_ms_per_token']:.3f} (routed experts only "
              f"{x['routed_bound_ms_per_token']:.3f}), kernel 5 launches "
              f"{x['kernel5_launches_per_rank']} (want {x['kernel5_want']}),"
              f" eager twin equal over {x['eager_twin_equal_tokens']} "
              f"tokens; batch {FAM_BATCH[0]} x {FAM_BATCH[1]}: "
              f"{b['tokens_per_s']:.1f} tok/s, ms/step "
              f"{b['ms_per_decode_step_per_rank']} | {smi}")
    print(f"[tp_families] (15a) peak memory per card "
          f"{a['peak_memory_bytes_per_card']}, weights per card "
          f"{a['weight_bytes_per_card']}, draw {a['setup_s']} s")
    for part, what in (("b", "jamba 8 layers f32"),
                       ("c", "rwkv6-7b f32"), ("d", "granite 16 layers f32")):
        x = rec[part]
        vs = x["vs_tp1"]
        print(f"[tp_families] (15{part}) {what} tp {FAM_TP}: "
              f"{x['tokens']} tokens, {x['tokens_per_s']:.1f} tok/s, "
              f"{x['kernel']} launches {x['kernel_launches_per_rank']} (want "
              f"{x['kernel_want']}), equal to tp=1 {vs['equal']}/"
              f"{vs['of']}, replays "
              f"{x['graph_replays']}, peak memory per card "
              f"{x['peak_memory_bytes_per_card']} | {smi}")
    for k, t in rec["e_scans"].items():
        print(f"[tp_families] (15e) {k}: {t['ms']:.5f} ms (bound "
              f"{t['bound_ms']:.6f} by {t['bound_by']}, plain "
              f"{t['plain_ms']:.4f}), bit-equal {t['bit_equal']} | {smi}")
    print(f"[time] (15) tp_families {rec['phase_s']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 16: speculation under tp and the multimodal stacks on the ring
# ---------------------------------------------------------------------------

SM_TP = 2
SM_OUT = 256                   # (a): batch 1, 32 in, 256 out
SM_BATCH = (4, 32)             # (a): 4 prompts x 32 new at 4 slots
SM_PROFILE_TOKENS = 32         # (a): tokens emitted under torch.profiler
SM_MAX_SEQ = 512
SM_B_DEPTH, SM_B_NEW = 8, 16   # (b): llava at 8 layers, f32
SM_K1_HEADS = (28, 4, 128)     # (e): llava's heads on a rank at tp 2


def sm_prompts(cfg, n, seed, length=None):
    """``n`` seeded prompts, each a random 8-token motif repeated to
    ``length`` tokens (16-40 when None): the n-gram drafter proposes
    from the first round on, whatever a random-weight model emits."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        motif = [int(t) for t in rng.randint(1, cfg.vocab_size, size=8)]
        size = length or int(rng.randint(16, 41))
        out.append((motif * (size // 8 + 1))[:size])
    return out


def sm_protocol(torch, ring, model, params, prompt, out_n, draft_k):
    """(a) at this rank: one request of ``out_n`` new tokens at batch 1
    (8-step windows, a bf16 pool), with the n-gram drafter at
    ``draft_k`` (0: none), on graphs over NCCL, after a warm-up request
    of the same prompt that captures its programs; SM_PROFILE_TOKENS
    emitted
    tokens in the middle under torch.profiler give device ms a token
    (NCCL's kernels apart), the engine's clock over the rest wall ms a
    token; kernel 1's launches exact over the request (once per layer
    per decode step and verify round)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    cfg, dev = model.cfg, ring.device
    knobs = dict(speculate="ngram", draft_k=draft_k) if draft_k else {}
    eng = LPUEngine(model, params, EngineConfig(
        slots=1, max_seq=SM_MAX_SEQ, steps_per_sync=OPT_WINDOW,
        kv_dtype="bfloat16", **knobs), device=dev, graphs=ring.nccl,
        mesh=ring)
    eng.generate([prompt], max_new_tokens=2 * OPT_WINDOW)
    torch.cuda.synchronize(dev)
    if eng.drafter is not None:
        from repro_torch.serving.drafter import ProposalLog
        eng.drafter = ProposalLog(eng.drafter)
    paged_decode_attention.launches = 0
    ring.reset_counters()
    st = eng.stats
    base = dataclasses.replace(st)
    v0 = eng._programs.replays_of("verify")
    rid = eng.submit(prompt, out_n)
    mid = len(prompt) + out_n // 2 - SM_PROFILE_TOKENS // 2
    seq = None
    while seq is None or seq.pos < mid:
        eng.step()
        seq = eng.sched.active[0]
        if seq is None:
            raise AssertionError(f"(16a) the request ended before {mid}")
    tok0, wall0, cap0 = st.tokens, st.wall, st.graph_captures
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while st.tokens - tok0 < SM_PROFILE_TOKENS and eng.sched.has_work():
            eng.step()
        torch.cuda.synchronize(dev)
    ptoks, window_wall = st.tokens - tok0, st.wall - wall0
    window_captures = st.graph_captures - cap0
    out = eng.drain()[rid]
    torch.cuda.synchronize(dev)

    def d(f):
        return getattr(st, f) - getattr(base, f)
    forwards = d("device_decode_steps") + d("spec_rounds")
    want = cfg.n_layers * (forwards + d("prefill_chunks"))
    launches = paged_decode_attention.launches
    what = (f"(16a) {cfg.name} tp {ring.size} draft_k {draft_k} rank "
            f"{ring.rank}")
    if launches != want or not want:
        raise AssertionError(f"{what}: kernel 1 launches {launches} != "
                             f"{want}")
    replays = d("graph_replays")
    if bool(replays) != eng.graphs:
        raise AssertionError(f"{what}: {replays} replays")
    verify_replays = eng._programs.replays_of("verify") - v0
    if eng.graphs and verify_replays != d("spec_rounds"):
        raise AssertionError(f"{what}: {verify_replays} verify replays for "
                             f"{d('spec_rounds')} verify rounds")
    if draft_k and not d("spec_rounds"):
        raise AssertionError(f"{what}: no verify round")
    pool_checks(eng, what)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us or not ptoks:
        raise AssertionError(f"{what}: the profiler saw {busy_us} us over "
                             f"{ptoks} tokens")
    device_ms = busy_us / 1e3 / ptoks
    nccl_ms = sum(e.self_device_time_total for e in kernels
                  if "nccl" in e.key.lower()) / 1e3 / ptoks
    wall_ms = (d("wall") - window_wall) * 1e3 / (len(out) - ptoks)
    rec = {"out": out, "draft_k": draft_k, "wall_ms_per_token": wall_ms,
           "device_ms_per_token": device_ms, "nccl_ms_per_token": nccl_ms,
           "device_busy_share": device_ms / wall_ms,
           "profiled_tokens": ptoks, "captures_in_profiled_window":
           window_captures, "captures_in_run": d("graph_captures"),
           "decode_steps": d("device_decode_steps"),
           "verify_rounds": d("spec_rounds"), "forwards": forwards,
           "tokens_per_forward": (len(out) - 1) / max(forwards, 1),
           "kernel1_launches": launches, "kernel1_want": want,
           "graph_replays": replays, "verify_replays": verify_replays,
           **ring_counts(ring, forwards),
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in sorted(kernels, key=lambda e:
                                           -e.self_device_time_total)[:8]]}
    if eng.drafter is not None:
        rec.update(spec_counts(eng))
    del eng
    free_cuda(torch)
    return rec


def sm_patches(torch, model, params, ring=None, tol=TOL["bfloat16"],
               what="(16)"):
    """llava's patch path (phase 11's inputs: 2880 seeded patch
    embeddings + LLAVA_TEXT text tokens) through the steps of
    ``core/steps.py`` (the ring's form with ``ring``, every rank alike),
    then LLAVA_STEPS serve steps; each token equal to its recompute
    twin's (a prefill over patches + text + the tokens so far) or apart
    only at the twin's top-2 gap <= ``tol``; the prefill's device ms
    under torch.profiler.  Returns the tokens and each twin's gap."""
    import numpy as np
    from repro_torch.core import esl
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    from repro_torch.device import dtype_of
    cfg, dev = model.cfg, model.device
    dt = dtype_of(model.plan.compute_dtype)
    n_p, S = cfg.vlm.n_patches, LLAVA_TEXT
    max_seq = n_p + S + LLAVA_STEPS
    g = torch.Generator(device=dev).manual_seed(11)
    patches = (0.1 * torch.randn((1, n_p, cfg.vlm.patch_embed_dim),
                                 generator=g, device=dev)).to(dt)
    rng = np.random.RandomState(11)
    text = torch.tensor(rng.randint(1, cfg.vocab_size, size=(1, S)),
                        device=dev)
    prefill, meta = build_prefill_step(model, ring, 1, max_seq)
    serve_step, _ = build_serve_step(model, ring, 1, max_seq)
    tok, cache = prefill(params, model.init_cache(1, max_seq, dtype=dt),
                         text, patch_embeds=patches)
    toks = [tok]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for t in range(LLAVA_STEPS):
        pos = torch.tensor([n_p + S + t], dtype=torch.int32, device=dev)
        tok, cache = serve_step(params, cache, toks[-1][:, None].long(), pos)
        toks.append(tok)
    torch.cuda.synchronize(dev)
    serve_ms = (time.perf_counter() - t0) / LLAVA_STEPS * 1e3
    out = torch.cat(toks).tolist()
    del cache
    kernels = device_kernels(lambda: (prefill(
        params, model.init_cache(1, max_seq, dtype=dt), text,
        patch_embeds=patches), torch.cuda.synchronize(dev)))
    gaps, apart = [], []
    with torch.no_grad():
        for j in range(len(out)):
            grown = torch.cat([text, torch.tensor([out[:j]], device=dev,
                                                  dtype=text.dtype)], 1)
            logits, _ = model.forward(
                params, grown, mode="prefill", patch_embeds=patches,
                env=meta["env"],
                cache=model.init_cache(1, n_p + grown.shape[1], dtype=dt))
            row = logits[0, -1].float()
            if ring is not None:
                row = esl.gather_scattered(row, axis=ring, tp=ring.size)
            gap = top2_gap(row).item()
            gaps.append(gap)
            if int(row.argmax()) != out[j]:
                if gap > tol:
                    raise AssertionError(
                        f"{what} llava patches: token {j} is {out[j]}, the "
                        f"recompute twin's {int(row.argmax())} at a top-2 "
                        f"gap {gap}")
                apart.append({"at": j, "top2_gap": gap})
    return {"tokens": out, "gaps": gaps, "patches": n_p, "text_tokens": S,
            "serve_steps": LLAVA_STEPS,
            "equal_to_recompute": len(out) - len(apart),
            "apart_at_near_ties": apart, "min_top2_gap": min(gaps),
            "prefill_device_ms": sum(e.self_device_time_total
                                     for e in kernels) / 1e3,
            "prefill_kernels": sum(e.count for e in kernels),
            "serve_wall_ms_per_step": serve_ms}


def sm_a(torch, ring, spec):
    """(a) at this rank: llava-next-34b whole in bf16, this rank's shard
    drawn alone; in ESL overlap and in blocking the protocol (batch 1, a
    32-token prompt of period 8, :func:`sm_prompts`) without and with
    the n-gram drafter (the speculative stream held to the plain one by
    the two-sided bf16 near-tie rule), SM_BATCH's batch at 4
    slots with speculation on graphs, then the patch path through the
    ring's steps; the bound from the bytes a card reads a step."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.weights import init_shard
    dev = ring.device
    cfg = get_config("llava-next-34b")
    if spec.get("depth"):
        cfg = dataclasses.replace(cfg, n_layers=spec["depth"])
    plans = ring_plans(cfg, ring.size, "bfloat16")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_shard(cfg, plans[True], ring.rank, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    wb = tree_bytes(params)
    rec = {"n_layers": cfg.n_layers, "setup_s": time.perf_counter() - t0,
           "weight_bytes": wb,
           "peak_memory_after_draw": torch.cuda.max_memory_allocated(dev),
           "runs": {}}
    prompt = sm_prompts(cfg, 1, 32, PAPER_IN_TOKENS)[0]
    bw = bandwidth_for(torch.cuda.get_device_name(dev))
    a = plans[True].attn
    peak = 0
    for key in ("overlap", "blocking"):
        model = build_model(cfg, plans[key == "overlap"], dev)
        r = {}
        for k in (0, SPEC_K):
            x = sm_protocol(torch, ring, model, params, prompt, spec["out"],
                            k)
            peak = max(peak, torch.cuda.max_memory_allocated(dev))
            mean_len = len(prompt) + len(x["out"]) / 2
            kv = 2 * cfg.n_layers * a.kv_per_rank * a.d_head * 2 * mean_len
            x.update(bytes_per_card_per_step=wb + kv,
                     bound_ms_per_token=(wb + kv) / bw * 1e3)
            r["spec" if k else "plain"] = x
        plain, sp = r["plain"].pop("out"), r["spec"].pop("out")
        want = {"stream": plain, "picks": None}
        if sp != plain:
            want["picks"] = top_picks(torch, model, params, prompt, plain,
                                      ring)
        r["spec"]["vs_plain"] = ring_agree_bf16(
            torch, ring, model, params, prompt, sp, want,
            f"(16a) {key} speculative vs plain rank {ring.rank}")
        r["stream_head"] = plain[:16]
        r["out_tokens"] = len(plain)
        free_cuda(torch)
        prompts = sm_prompts(cfg, SM_BATCH[0], 19)
        streams, b = ring_engine_run(torch, ring, model, params, prompts,
                                     SM_BATCH[1], True, slots=SM_BATCH[0],
                                     max_seq=SM_MAX_SEQ, knobs=dict(
                                         speculate="ngram", draft_k=SPEC_K))
        b["streams_head"] = [x[:8] for x in streams]
        b["ms_per_forward"] = b["wall_s"] * 1e3 / max(
            b["device_decode_steps"] + b["spec_rounds"], 1)
        r["batch4_spec"] = b
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
        free_cuda(torch)
        r["patches"] = sm_patches(torch, model, params, ring,
                                  what=f"(16a) {key}")
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
        rec["runs"][key] = r
        del model
        free_cuda(torch)
        if ring.rank == 0:
            print(f"[tp_spec_mm] (16a) llava tp {ring.size} {key} rank 0: "
                  f"plain {r['plain']['wall_ms_per_token']:.3f} ms/token "
                  f"wall, {r['plain']['device_ms_per_token']:.3f} device; "
                  f"speculative {r['spec']['wall_ms_per_token']:.3f} wall, "
                  f"{r['spec']['tokens_per_forward']:.2f} tokens a "
                  f"forward; bound {r['plain']['bound_ms_per_token']:.3f}",
                  flush=True)
    rec["peak_memory_bytes"] = peak
    del params
    free_cuda(torch)
    return rec


def sm_b(torch, ring, spec):
    """(b) at this rank: llava at SM_B_DEPTH layers in f32, this rank's
    shard drawn alone, through the engine with the n-gram drafter on
    graphs (ESL overlap) and through the patch path; the streams and the
    patch tokens against tp=1's, apart only at a top-2 gap <= CHAIN_TOL
    of the ring's model."""
    from repro_torch.models.registry import build_model
    from repro_torch.weights import init_shard
    dev = ring.device
    cfg = fam_cfg("llava-next-34b", SM_B_DEPTH)
    plan = ring_plans(cfg, ring.size)[True]
    params = init_shard(cfg, plan, ring.rank, seed=0, device=dev)
    model = build_model(cfg, plan, dev)
    what = f"(16b) llava {SM_B_DEPTH} layers tp {ring.size} rank {ring.rank}"
    prompts = spec["prompts"]
    streams, rec = ring_engine_run(
        torch, ring, model, params, prompts, SM_B_NEW, True,
        max_seq=SM_MAX_SEQ, knobs=dict(speculate="ngram", draft_k=SPEC_K))
    rec["vs_tp1"] = ring_agree(torch, ring, model, params, prompts, streams,
                               spec["want"], CHAIN_TOL, what)
    p = sm_patches(torch, model, params, ring, CHAIN_TOL, what)
    at = next((j for j, (u, v) in enumerate(zip(p["tokens"],
                                                spec["patch_want"]))
               if u != v), None)
    if at is not None and p["gaps"][at] > CHAIN_TOL:
        raise AssertionError(f"{what}: patch token {at} is "
                             f"{p['tokens'][at]}, tp=1's "
                             f"{spec['patch_want'][at]}, at a top-2 gap "
                             f"{p['gaps'][at]}")
    p["vs_tp1_first_apart"] = at
    rec.update(streams=streams, patches=p,
               peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
    del model, params
    free_cuda(torch)
    return rec


def sm_c(torch, ring, spec):
    """(c) at this rank: full-width opt-1.3b in f32 (ESL overlap, this
    rank's shard drawn alone) with (h1)'s traffic and the n-gram drafter
    on fused sampling on graphs, its eager twin, and host sampling on
    graphs: every verify round of the fused run replayed, its
    collectives those of the eager twin, every stream tp=1's or apart
    only at a top-2 gap <= CHAIN_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.drafter import ProposalLog
    from repro_torch.serving.engine import LPUEngine
    dev = ring.device
    cfg = get_config("opt-1.3b")
    plan = ring_plans(cfg, ring.size)[True]
    params = rank_weights(cfg, plan, ring.rank, dev)
    model = build_model(cfg, plan, dev)
    prompts, want = spec["prompts"], spec["want"]
    out = {}
    for key, graphs, knobs in (("fused", True, {}),
                               ("fused_eager", False, {}),
                               ("host", True, dict(sampling="host"))):
        what = f"(16c) opt-1.3b tp {ring.size} {key} rank {ring.rank}"
        eng = LPUEngine(model, params, EngineConfig(
            slots=4, max_seq=512, block_size=BS, speculate="ngram",
            draft_k=SPEC_K, **knobs), mesh=ring, device=dev,
            graphs=graphs and ring.nccl)
        eng.generate(prompts[:1], max_new_tokens=2)
        torch.cuda.synchronize(dev)
        eng.stats = type(eng.stats)()
        eng.drafter = ProposalLog(eng.drafter)
        v0 = eng._programs.replays_of("verify")
        paged_decode_attention.launches = 0
        ring.reset_counters()
        t0 = time.perf_counter()
        streams = eng.generate(prompts, max_new_tokens=TP_NEW)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        st = eng.stats
        launches = paged_decode_attention.launches
        r = dict(run_rec(eng, launches), wall_s=wall,
                 tokens_per_s=st.tokens / wall, graphs=eng.graphs,
                 kernel1_want=launches_want(eng),
                 verify_replays=eng._programs.replays_of("verify") - v0,
                 **spec_counts(eng), **ring_counts(ring,
                                                   st.device_decode_steps))
        if launches != r["kernel1_want"] or not launches:
            raise AssertionError(f"{what}: kernel 1 launches {launches} != "
                                 f"{r['kernel1_want']}")
        if not st.spec_rounds:
            raise AssertionError(f"{what}: no verify round")
        if key == "fused" and eng.graphs and \
                r["verify_replays"] != st.spec_rounds:
            raise AssertionError(f"{what}: {r['verify_replays']} verify "
                                 f"replays for {st.spec_rounds} rounds")
        on_graphs(eng)
        pool_checks(eng, what)
        del eng
        r["vs_tp1"] = ring_agree(torch, ring, model, params, prompts,
                                 streams, want, CHAIN_TOL, what)
        r["streams"] = streams
        out[key] = r
        if ring.rank == 0:
            print(f"[tp_spec_mm] (16c) {key} rank 0: {r['tokens_per_s']:.1f}"
                  f" tok/s, {st.spec_rounds} verify rounds", flush=True)
    f, e = out["fused"], out["fused_eager"]
    if f["streams"] != e["streams"]:
        raise AssertionError("(16c) fused on graphs vs its eager twin: "
                             "streams differ")
    if ring.nccl and (f["collectives"], f["hops"]) != (e["collectives"],
                                                       e["hops"]):
        raise AssertionError(f"(16c) the graphs' collectives "
                             f"{f['collectives']}/{f['hops']} != the eager "
                             f"twin's {e['collectives']}/{e['hops']}")
    del model, params
    free_cuda(torch)
    return out


def tp_spec_mm_rank(ring, spec):
    """One rank of phase 16 (rank r on ``cuda:r``, NCCL): (a) to (d) in
    turn, each model freed before the next; returns every rank's
    record."""
    import torch
    out = {"rank": ring.rank, "device": str(ring.device),
           "card": torch.cuda.get_device_name(ring.device),
           "backend": ring.backend}
    for part, fn in (("a", sm_a), ("b", sm_b), ("c", sm_c),
                     ("d", lambda torch, ring, sp: ring_whisper(
                         torch, ring, sp, "(16d)"))):
        t0 = time.perf_counter()
        out[part] = fn(torch, ring, spec[part])
        out[f"{part}_s"] = time.perf_counter() - t0
        if ring.rank == 0:
            print(f"[tp_spec_mm] (16{part}) rank 0 done in "
                  f"{out[f'{part}_s']:.1f} s", flush=True)
    return ring.gather_object(out)


def check_time_llava_rank_k1(torch, dev, card_name):
    """(e): kernel 1 at llava-next-34b's heads on a rank at tp 2
    (SM_K1_HEADS: 28 query heads over 4 kv heads, dh 128, bf16 pool), at
    the decode shape (B 1 and B 4, lengths LENGTHS, the fold) and at the
    verify shape (VERIFY_POS's 4 slots x VERIFY_K1 queries, a table
    each, no fold), against its plain version (3e-2), timed beside it,
    the library call (gather + SDPA with GQA) and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        gather_kv_pages, paged_decode_attention_ref)
    hq, gk, dh = SM_K1_HEADS
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(16)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)
    kp0, vp0 = rnd(N, BS, gk, dh), rnd(N, BS, gk, dh)
    cases = {}
    for b in (1, 4):
        lens = list(LENGTHS[-b:])
        tb = torch.zeros((b, T), dtype=torch.int32)
        for i, n in enumerate(lens):
            used = -(-n // BS)
            tb[i, :used] = torch.arange(1 + T * i, 1 + T * i + used)
        cases[f"decode_b{b}"] = (tb, lens, True)
    tb = torch.zeros((len(VERIFY_POS), T), dtype=torch.int32)
    for i, p in enumerate(VERIFY_POS):
        used = -(-(p + VERIFY_K1) // BS)
        tb[i, :used] = torch.arange(1 + T * i, 1 + T * i + used)
    cases["verify"] = (tb.repeat_interleave(VERIFY_K1, 0),
                       [p + 1 + j for p in VERIFY_POS
                        for j in range(VERIFY_K1)], False)
    out = {}
    for key, (tb, lens, fold) in cases.items():
        Q = tb.shape[0]
        tb = tb.to(dev)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = rnd(Q, hq, dh)
        kw = dict(k_new=rnd(Q, gk, dh), v_new=rnd(Q, gk, dh)) if fold else {}
        got = paged_decode_attention(q, kp0, vp0, tb, ln, **kw)
        want = paged_decode_attention_ref(q, kp0, vp0, tb, ln, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.isfinite(got).all() or err > TOL["bfloat16"]:
            raise AssertionError(f"(16e) kernel 1 at llava's rank heads, "
                                 f"{key}: max abs {err}")
        n_sets = sets_for(2 * kp0.numel() * kp0.element_size())
        pools = [(kp0.clone(), vp0.clone()) for _ in range(n_sets)]
        valid = torch.arange(T * BS, device=dev)[None] < ln[:, None]
        if fold:
            valid = torch.cat([valid, torch.ones((Q, 1), dtype=torch.bool,
                                                 device=dev)], 1)
        mask = valid[:, None, None]

        def library(i, tb=tb, kw=kw, mask=mask, q=q):
            k = gather_kv_pages(pools[i][0], tb)
            v = gather_kv_pages(pools[i][1], tb)
            if kw:
                k = torch.cat([k, kw["k_new"][:, None]], 1)
                v = torch.cat([v, kw["v_new"][:, None]], 1)
            F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        t = timed(torch, {
            "ms": lambda i, tb=tb, ln=ln, kw=kw, q=q: paged_decode_attention(
                q, pools[i][0], pools[i][1], tb, ln, **kw),
            "plain_ms": lambda i, tb=tb, ln=ln, kw=kw, q=q:
                paged_decode_attention_ref(q, pools[i][0], pools[i][1], tb,
                                           ln, **kw),
            "library_ms": library}, n_sets)
        # least work: q, each slot's valid K/V rows (and the new token),
        # tables and lengths read once, the output written once; 4 dh
        # flops per q head per attended position
        item = kp0.element_size()
        slot_rows = (sum(LENGTHS[-Q:]) if fold else
                     sum(p + VERIFY_K1 for p in VERIFY_POS))
        new = Q if fold else 0
        nbytes = item * (2 * Q * hq * dh + 2 * (slot_rows + new) * gk * dh) \
            + 4 * (Q * T + Q)
        attended = sum(lens) + new
        t["bound_ms"], t["bound_by"] = bound_for(
            nbytes, 4 * dh * hq * attended, "bfloat16", card_name)
        t.update(max_abs_err=err, tol=TOL["bfloat16"], shapes={
            "Q": Q, "H": hq, "G": gk, "gs": hq // gk, "dh": dh, "bs": BS,
            "T": T, "lengths": lens, "dtype": "bfloat16", "fold": fold})
        out[key] = t
        del pools
    return out


def sm_tp1(torch, dev):
    """The tp=1 references of phase 16 on ``dev``, each model freed
    after: (b) llava at SM_B_DEPTH layers in f32 (its streams and patch
    tokens), (c) opt-1.3b in f32 with (h1)'s traffic, (d) whisper-tiny's
    tokens through the steps."""
    from repro_torch.configs import get_config
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    rec = {}
    model, params, _ = family_model(torch, dev, "llava-next-34b", "float32",
                                    SM_B_DEPTH)
    prompts = sm_prompts(model.cfg, 4, 21)
    eng = LPUEngine(model, params, EngineConfig(
        slots=len(prompts), max_seq=SM_MAX_SEQ, block_size=BS), device=dev)
    rec["b"] = {"prompts": prompts,
                "want": eng.generate(prompts, max_new_tokens=SM_B_NEW),
                "patch_want": sm_patches(torch, model, params, None,
                                         CHAIN_TOL, "(16b) tp=1")["tokens"]}
    del eng, model, params
    free_card(torch, "after (16b)'s tp=1 reference")
    model, params = opt_model(torch, dev, "opt-1.3b")
    prompts = opt_prompts(get_config("opt-1.3b"))[0]
    rec["c"] = {"prompts": prompts, "want": serve(
        torch, dev, model, params, prompts, paged_kernel="stream")[0]}
    del model, params
    free_card(torch, "after (16c)'s tp=1 reference")
    model, params, _ = family_model(torch, dev, "whisper-tiny", "float32")
    frames, prompt = whisper_inputs(torch, dev, model.cfg)
    rows, S = prompt.shape
    pre, _ = build_prefill_step(model, None, rows, 64)
    step, _ = build_serve_step(model, None, rows, 64)
    tok, cache = pre(params, model.init_cache(rows, 64), prompt,
                     frames=frames)
    toks = [tok]
    for t in range(TP_WHISPER_STEPS):
        pos = torch.full((rows,), S + t, dtype=torch.int32, device=dev)
        tok, cache = step(params, cache, toks[-1][:, None].long(), pos)
        toks.append(tok)
    rec["d"] = {"want": torch.stack(toks, 1).tolist(),
                "steps": TP_WHISPER_STEPS}
    del model, params, cache
    free_card(torch, "after (16d)'s tp=1 reference")
    return rec


def run_tp_spec_mm(torch, dev, card_name, lap=None,
                   placement="card_per_rank", a_depth=None):
    """Phase 16 on a machine of 2 or more cards: (e) kernel 1 at llava's
    rank heads on cuda:0; the tp=1 references on cuda:0 (:func:`sm_tp1`),
    then a ring of SM_TP ranks, each on its own card over NCCL, every
    step on graphs, each rank drawing only its shard: (a) llava-next-34b
    whole, (b) llava at 8 layers, (c) opt-1.3b, (d) whisper-tiny.
    ``placement="shared_card"`` (with ``a_depth``, (a)'s depth cut)
    rehearses the phase on one card (the ranks share it over gloo, steps
    eager)."""
    from repro_torch.core.dist import run_ranks
    t_phase = time.perf_counter()
    rec = {"card": card_name, "cards": torch.cuda.device_count(),
           "cards_listed": smi_query("--query-gpu=index,name,power.limit",
                                     "--format=csv,noheader").splitlines()}
    t0 = time.perf_counter()
    rec["e_kernel1"] = check_time_llava_rank_k1(torch, dev, card_name)
    rec["e_s"] = time.perf_counter() - t0
    if lap is not None:
        lap("(16e) kernel 1")
    t0 = time.perf_counter()
    refs = sm_tp1(torch, dev)
    rec["tp1_s"] = time.perf_counter() - t0
    if lap is not None:
        lap("(16) tp=1 references")
    spec = {"a": {"out": SM_OUT, "depth": a_depth}, **refs}
    t0 = time.perf_counter()
    per_rank = run_ranks(tp_spec_mm_rank, SM_TP, spec, device="cuda",
                         placement=placement, timeout_s=600)
    rec["ranks_s"] = time.perf_counter() - t0
    rec["backend"] = same_on_ranks(per_rank, lambda x: x["backend"],
                                   "backend")
    rec["rank_cards"] = [x["card"] for x in per_rank]
    rec["part_s"] = [{p: x[f"{p}_s"] for p in "abcd"} for x in per_rank]
    a = [x["a"] for x in per_rank]
    ra = {"arch": "llava-next-34b", "dtype": "bfloat16",
          "n_layers": a[0]["n_layers"], "tp": SM_TP,
          "setup_s": [x["setup_s"] for x in a],
          "weight_bytes_per_card": [x["weight_bytes"] for x in a],
          "peak_memory_bytes_per_card": [x["peak_memory_bytes"] for x in a],
          "peak_memory_after_draw_per_card": [x["peak_memory_after_draw"]
                                              for x in a], "runs": {}}
    for key in a[0]["runs"]:
        rr = [x["runs"][key] for x in a]
        same_on_ranks(rr, lambda x: x["stream_head"], f"(16a) {key} stream")
        one = {"stream_head": rr[0]["stream_head"],
               "out_tokens": rr[0]["out_tokens"]}
        for sub in ("plain", "spec"):
            xs = [x[sub] for x in rr]
            one[sub] = {k: v for k, v in xs[0].items()
                        if k != "top_kernels"}
            for k in ("wall_ms_per_token", "device_ms_per_token",
                      "nccl_ms_per_token", "kernel1_launches"):
                one[sub][f"{k}_per_rank"] = [x[k] for x in xs]
            one[sub]["top_kernels_rank0"] = xs[0]["top_kernels"]
        same_on_ranks([x["spec"] for x in rr], lambda x: [x[f] for f in (
            "spec_rounds", "draft_tokens", "accepted_tokens",
            "proposals_crc32")], f"(16a) {key} drafts and acceptance")
        bb = [x["batch4_spec"] for x in rr]
        same_on_ranks(bb, lambda x: [x["streams_head"], x["proposals_crc32"],
                                     x["accepted_tokens"]],
                      f"(16a) {key} batch streams and drafts")
        one["batch4_spec"] = dict(
            {k: v for k, v in bb[0].items() if k != "cache_shapes"},
            kernel1_launches_per_rank=[x["kernel_launches"] for x in bb])
        pp = [x["patches"] for x in rr]
        same_on_ranks(pp, lambda x: x["tokens"], f"(16a) {key} patches")
        one["patches"] = dict({k: v for k, v in pp[0].items()
                               if k != "gaps"},
                              prefill_device_ms_per_rank=[
                                  x["prefill_device_ms"] for x in pp])
        ra["runs"][key] = one
    rec["a"] = ra
    rb = [x["b"] for x in per_rank]
    same_on_ranks(rb, lambda x: [x["streams"], x["patches"]["tokens"]],
                  "(16b) streams and patch tokens")
    rec["b"] = dict({k: v for k, v in rb[0].items()
                     if k not in ("streams", "cache_shapes")},
                    kernel1_launches_per_rank=[x["kernel_launches"]
                                               for x in rb],
                    peak_memory_bytes_per_card=[x["peak_memory_bytes"]
                                                for x in rb])
    rec["b"]["patches"].pop("gaps")
    rc = [x["c"] for x in per_rank]
    rec["c"] = {}
    for key in rc[0]:
        rr = [x[key] for x in rc]
        same_on_ranks(rr, lambda x: [x["streams"], x["proposals_crc32"],
                                     x["accepted_tokens"]],
                      f"(16c) {key} streams and drafts")
        rec["c"][key] = dict({k: v for k, v in rr[0].items()
                              if k != "streams"},
                             kernel1_launches_per_rank=[
                                 x["kernel_launches"] for x in rr])
    rd = [x["d"] for x in per_rank]
    same_on_ranks(rd, lambda x: x["tokens"], "(16d) whisper tokens")
    rec["d"] = dict({k: v for k, v in rd[0].items() if k != "tokens"},
                    tokens_head=[t[:4] for t in rd[0]["tokens"]])
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def print_tp_spec_mm(rec, smi):
    """The phase's summary lines."""
    a = rec["a"]
    for k, x in a["runs"].items():
        p, s, b, pt = x["plain"], x["spec"], x["batch4_spec"], x["patches"]
        print(f"[tp_spec_mm] (16a) llava-next-34b {a['n_layers']} layers "
              f"bf16 tp {a['tp']} {k}: plain ms/token wall "
              f"{p['wall_ms_per_token_per_rank']} device "
              f"{p['device_ms_per_token_per_rank']} (NCCL "
              f"{p['nccl_ms_per_token_per_rank']}), bound "
              f"{p['bound_ms_per_token']:.3f}; n-gram k {SPEC_K}: wall "
              f"{s['wall_ms_per_token_per_rank']} device "
              f"{s['device_ms_per_token_per_rank']}, acceptance "
              f"{s['acceptance_rate']:.3f}, tokens a forward "
              f"{s['tokens_per_forward']:.2f}, vs plain "
              f"{s['vs_plain']['equal']}/1; kernel 1 launches "
              f"{p['kernel1_launches_per_rank']} / "
              f"{s['kernel1_launches_per_rank']} (want "
              f"{p['kernel1_want']} / {s['kernel1_want']}) | {smi}")
        print(f"[tp_spec_mm] (16a) {k}: batch {SM_BATCH[0]} x {SM_BATCH[1]} "
              f"speculative {b['tokens_per_s']:.1f} tok/s, acceptance "
              f"{b['acceptance_rate']:.3f}, verify replays "
              f"{b['verify_replays']}; patches {pt['patches']} + "
              f"{pt['text_tokens']}: prefill device "
              f"{pt['prefill_device_ms_per_rank']} ms, serve "
              f"{pt['serve_wall_ms_per_step']:.2f} ms/step wall, equal to "
              f"the recompute twin {pt['equal_to_recompute']}/"
              f"{len(pt['tokens'])} | {smi}")
    print(f"[tp_spec_mm] (16a) peak memory per card "
          f"{a['peak_memory_bytes_per_card']}, weights per card "
          f"{a['weight_bytes_per_card']}, draw {a['setup_s']} s")
    b = rec["b"]
    print(f"[tp_spec_mm] (16b) llava {SM_B_DEPTH} layers f32 tp {SM_TP}: "
          f"speculative engine equal to tp=1 {b['vs_tp1']['equal']}/"
          f"{b['vs_tp1']['of']}, acceptance {b['acceptance_rate']:.3f}, "
          f"verify replays {b['verify_replays']}; patch tokens first apart "
          f"from tp=1 at {b['patches']['vs_tp1_first_apart']} | {smi}")
    for k, x in rec["c"].items():
        print(f"[tp_spec_mm] (16c) opt-1.3b f32 tp {SM_TP} {k}: "
              f"{x['tokens_per_s']:.1f} tok/s, {x['spec_rounds']} verify "
              f"rounds ({x['verify_replays']} replayed), acceptance "
              f"{x['acceptance_rate']:.3f}, {x['collectives']} collectives, "
              f"kernel 1 {x['kernel1_launches_per_rank']} (want "
              f"{x['kernel1_want']}), equal to tp=1 {x['vs_tp1']['equal']}/"
              f"{x['vs_tp1']['of']} | {smi}")
    d = rec["d"]
    print(f"[tp_spec_mm] (16d) whisper-tiny f32 tp {SM_TP}: equal to tp=1 "
          f"{d['equal']}/{d['of']}, serve {d['serve_wall_ms_per_step']:.2f} "
          f"ms/step wall | {smi}")
    for k, t in rec["e_kernel1"].items():
        print(f"[tp_spec_mm] (16e) kernel 1 at llava's rank heads {k}: "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.4f}, library "
              f"{t['library_ms']:.4f}, bound {t['bound_ms']:.6f} "
              f"({t['bound_by']}), max abs {t['max_abs_err']:.3g} | {smi}")
    print(f"[time] (16) tp_spec_mm {rec['phase_s']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 17: the mesh fleet and the front end over the ESL ring (4 cards)
# ---------------------------------------------------------------------------

TPF_TP, TPF_RINGS = 2, 2
# (a)-(c): phase 9's fleet knobs, prompts made resident in chunks of 64
# (kernel 1's chunk caller beside its decode caller), blocking collectives
# (the faster mode on every ring measured, PERF.md §6)
TPF_KW = dict(FLEET_KW, prefill_chunk=PREFILL_CHUNK)
TPF_NEW = 32
# (b): nan on sub-ring 0 at its step 3, then ring on sub-ring 1 at its
# step 5: ring 0's orphans migrate to ring 1, where they run out of
# migrations; ring 1's own migrate to ring 0 and finish there
TPF_CHAOS = dict(chaos="nan@3:0,ring@5:1", max_migrations=1)
# (c): phase 10's trace (cut its requests first if the phase runs long)
TPF_TRACE_REQUESTS = 32
# (d): opt-66b bf16, 4 prompts of 32 tokens each sent twice (once to each
# ring: the same batch on both) x 128 new, 4 slots a ring
TPF_D_PROMPTS, TPF_D_IN, TPF_D_NEW = 4, 32, 128
TPF_D_KW = dict(slots=4, max_seq=256, block_size=128, paged=True,
                paged_kernel="stream")
# The single ring at tp 2 (opt-66b bf16, batch 1, blocking, the paper's
# protocol; measured on two NVIDIA H100 80GB HBM3 at 700 W): another
# run, printed beside (d)
TPF_ONE_RING_OPT66_MS = 43.80


def tpf_cfg(name, reduced):
    """Full-width ``name``, or (a rehearsal on the CPU) its reduced
    config with a position table as long as the phase's ``max_seq``."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if not reduced:
        return cfg
    return dataclasses.replace(cfg.reduced(), max_seq=TPF_KW["max_seq"])


def tpf_programs(eng):
    """{program key: its collectives per replay} of an engine's captured
    windows and admission programs (on a gloo ring: nothing captured)."""
    return {repr(k): p.collectives.get("collectives", 0)
            for progs in (eng._programs, eng._admit)
            for k, p in progs._by_key.items()
            if getattr(p, "graph", None) is not None}


def tpf_trace(cfg):
    from repro_torch.serving.traces import TraceConfig, generate_trace
    kw = dict(FRONTEND_TRACE, requests=TPF_TRACE_REQUESTS)
    return generate_trace(TraceConfig(**kw, vocab=cfg.vocab_size))


def tpf_frontends(torch, world, sub, eng, model, params, trace, blocking,
                  what):
    """(c) on ``eng`` (a lone ring's engine or a mesh fleet): the trace
    through the front end on world rank 0, budget off and on, the other
    ranks following; every stream held to ``blocking`` (the blocking run
    of the trace on the same engine) on every rank of every ring, and
    every rank's orders equal.  Returns rank 0's records."""
    from repro_torch.serving.budget import BudgetScheduler
    from repro_torch.serving.frontend import AsyncFrontend
    agreement = world.agreement()
    prompts = [list(r.prompt) for r in trace]
    out = {}
    for key, budget in (("budget_off", False), ("budget_on", True)):
        fe_kw = ({"budget": BudgetScheduler(FRONTEND_BUDGET_MS,
                                            max_chunk=FRONTEND_MAX_CHUNK)}
                 if budget else {})
        rec = None
        if world.rank == 0:
            run = serve_frontend(torch, eng, trace, **fe_kw)
            fe, streams = run[0], run[1]
            rec = frontend_record(trace, *run)
            got = [s.tokens for s in streams]
            if budget:
                bud = fe_kw["budget"]
                rec.update(plans=len(bud.planned),
                           distinct_plans=sorted(
                               {(c, s) for c, s in bud.planned},
                               key=repr),
                           mu_step_ms=bud.mu_step * 1e3)
        else:
            fe = AsyncFrontend(eng)
            fe.follow()
            got = None
        got = agreement.announce(got)
        orders = agreement.gather((fe.orders_crc, fe.orders_applied))
        if len(set(orders)) != 1:
            raise AssertionError(f"{what} {key}: the ranks applied other "
                                 f"orders: {orders}")
        vs = ring_agree(torch, sub, model, params, prompts, got, blocking,
                        CHAIN_TOL, f"{what} {key} against blocking")
        if rec is not None:
            rec.update(vs_blocking=vs, orders_crc=f"{orders[0][0]:08x}",
                       orders_applied=orders[0][1])
            out[key] = rec
    return out


def tpf_ring_rank(ring, spec):
    """Phase 17 on a lone ring of tp 2 (cards 0-1; rank r on ``cuda:r``,
    NCCL, graphs): (a) opt-1.3b f32 blocking on phase 9's traffic, its
    programs' collectives; (c) the trace blocking, then through the
    front end.  Returns every rank's record."""
    import torch
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    dev = ring.device
    t0 = time.perf_counter()
    cfg = tpf_cfg("opt-1.3b", spec["reduced"])
    plan = ring_plans(cfg, ring.size)[False]
    params = rank_weights(cfg, plan, ring.rank, dev)
    model = build_model(cfg, plan, dev)
    eng = LPUEngine(model, params, EngineConfig(**TPF_KW), mesh=ring,
                    device=dev, graphs=ring.nccl)
    prompts, what = spec["prompts"], "(17a) lone ring"
    eng.generate([p[:8] for p in prompts[:1]], max_new_tokens=2)
    torch.cuda.synchronize(dev)
    eng.stats = type(eng.stats)()
    paged_decode_attention.launches = 0
    ring.reset_counters()
    t1 = time.perf_counter()
    streams = eng.generate(prompts, max_new_tokens=TPF_NEW)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t1
    launches = paged_decode_attention.launches
    # (on the CPU, where a rehearsal runs, the plain version launches
    # nothing)
    if dev.type == "cuda" and (launches != launches_want(eng)
                               or not launches):
        raise AssertionError(f"{what}: kernel 1 launches {launches} != "
                             f"{launches_want(eng)}")
    on_graphs(eng)
    pool_checks(eng, what)
    st = eng.stats
    a = dict(run_rec(eng, launches), wall_s=wall,
             tokens_per_s=st.tokens / wall,
             **ring_counts(ring, st.device_decode_steps),
             programs=tpf_programs(eng),
             vs_tp1=ring_agree(torch, ring, model, params, prompts, streams,
                               spec["want"], CHAIN_TOL, what),
             streams=streams)
    trace = tpf_trace(cfg)
    base, bwall, _ = serve_blocking(torch, eng, trace)
    c = {"blocking": {"tokens": sum(map(len, base)), "wall_s": bwall,
                      "tokens_per_s": sum(map(len, base)) / bwall}}
    c.update(tpf_frontends(torch, ring, ring, eng, model, params, trace,
                           base, "(17c) lone ring"))
    out = {"rank": ring.rank, "card": str(dev), "a": a,
           "c": c if ring.rank == 0 else None,
           "s": time.perf_counter() - t0}
    return ring.agreement().gather(out)


def tpf_checked_reset():
    """LPUEngine.reset wrapped: raises unless a reset keeps every cache
    tensor's storage, the captures and the program keys (the drained
    sub-ring is rebuilt in place with no new capture); counts resets.
    Returns (the original, the count box)."""
    from repro_torch.serving.engine import LPUEngine
    orig, box = LPUEngine.reset, {"resets": 0}

    def checked(self):
        ptrs, caps = cache_ptrs(self), captures_of(self)
        keys = (set(self._programs._by_key), set(self._admit._by_key))
        orphans = orig(self)
        if cache_ptrs(self) != ptrs or captures_of(self) != caps or \
                keys != (set(self._programs._by_key),
                         set(self._admit._by_key)):
            raise AssertionError(f"(17b) reset of ring {self.ring_id} "
                                 "moved the cache or changed its programs")
        box["resets"] += 1
        return orphans
    LPUEngine.reset = checked
    return orig, box


def tpf_fleet_run(torch, fleet, prompts, new):
    """Serve ``prompts`` x ``new`` on a warmed mesh fleet, its counters
    and the local engine's read from zero over the run: (streams, the
    local engine's kernel 1 launches, the fleet's wall)."""
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    dev = fleet.local.device
    fleet.local.stats = type(fleet.local.stats)()
    for v in fleet.engines:
        v.stats = type(v.stats)()
    fleet.wall = 0.0
    fleet.router.routed = [0] * fleet.n_rings
    fleet.sub.reset_counters()
    fleet.world.reset_counters()
    paged_decode_attention.launches = 0
    streams = fleet.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize(dev)
    return streams, paged_decode_attention.launches, fleet.wall


def tpf_fleet_gates(fleet, launches, what):
    eng = fleet.local
    if eng.device.type == "cuda" and (launches != launches_want(eng)
                                      or not launches):
        raise AssertionError(f"{what}: kernel 1 launches {launches} != "
                             f"{launches_want(eng)} on ring "
                             f"{fleet.ring_index}")
    on_graphs(eng)
    if eng.graphs and not eng.stats.graph_replays:
        raise AssertionError(f"{what}: no replay")
    pool_checks(eng, what)
    if fleet.world.counters["collectives"]:
        raise AssertionError(f"{what}: {fleet.world.counters} collectives "
                             "on the world group")


def tpf_a(torch, fleet, model, params, spec):
    """(a) on the mesh fleet: phase 9's traffic against tp=1, routes,
    kernel 1, replays, each program's collectives against the lone
    ring's, nothing on the world group."""
    what = "(17a) fleet"
    prompts = spec["prompts"]
    streams, launches, wall = tpf_fleet_run(torch, fleet, prompts, TPF_NEW)
    tpf_fleet_gates(fleet, launches, what)
    eng, sub = fleet.local, fleet.sub
    mine, lone = tpf_programs(eng), spec["lone_programs"]
    common = sorted(set(mine) & set(lone))
    if eng.graphs and (not any("window" in k for k in common) or
                       not any("chunk" in k for k in common)):
        raise AssertionError(f"{what}: programs {sorted(mine)} beside the "
                             f"lone ring's {sorted(lone)}")
    apart = {k: (mine[k], lone[k]) for k in common if mine[k] != lone[k]}
    if apart:
        raise AssertionError(f"{what}: collectives per replay {apart} "
                             "(fleet, lone ring)")
    # balanced as the router balances: least outstanding tokens, the
    # loads of the prompts submitted before the first round
    from repro_torch.serving.scheduler import RingRouter
    replay, loads = RingRouter(fleet.n_rings), [0] * fleet.n_rings
    for p in prompts:
        loads[replay.route(loads)] += len(p) + TPF_NEW
    if fleet.router.routed != replay.routed:
        raise AssertionError(f"{what}: routed {fleet.router.routed}, the "
                             f"least-loaded rule {replay.routed}")
    tokens = sum(s.tokens for s in fleet.per_ring_stats())
    st = eng.stats
    return {"streams": streams, "routed": list(fleet.router.routed),
            "routed_tokens": loads, "fleet_wall_s": wall, "tokens": tokens,
            "tokens_per_s": tokens / wall,
            "per_ring_tokens": [s.tokens for s in fleet.per_ring_stats()],
            "kernel1_launches": launches,
            "kernel1_want": launches_want(eng),
            "graph_replays": st.graph_replays,
            "graph_captures": st.graph_captures,
            "device_decode_steps": st.device_decode_steps,
            "prefill_chunks": st.prefill_chunks,
            **ring_counts(sub, st.device_decode_steps),
            "programs_checked": common,
            "world_collectives": fleet.world.counters["collectives"],
            "vs_tp1": ring_agree(torch, sub, model, params, prompts,
                                 streams, spec["want"], CHAIN_TOL, what)}


def tpf_b(torch, ring, model, params, spec, clean):
    """(b): TPF_CHAOS on a fresh mesh fleet (a ManualClock), every
    reset checked in place: orphans migrate across processes, the
    survivors' streams are (a)'s, the requests out of migrations end as
    structured failures, the fleet's counters equal on every rank."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import MultiRingEngine
    what = "(17b) chaos"
    prompts = spec["prompts"]
    orig, box = tpf_checked_reset()
    try:
        fleet = MultiRingEngine(model, params, ring, ring_size=TPF_TP,
                                config=EngineConfig(**dict(TPF_KW,
                                                           **TPF_CHAOS)),
                                device=ring.device, graphs=ring.nccl)
        rids = [fleet.submit(p, TPF_NEW) for p in prompts]
        first = {r: fleet.ring_of[r] for r in rids}
        res = fleet.drain()
    finally:
        from repro_torch.serving.engine import LPUEngine
        LPUEngine.reset = orig
    torch.cuda.synchronize(ring.device)
    fc = fleet.fleet_counters()
    moved = [r for r in rids if fleet.ring_of[r] != first[r]]
    if not fc["migrated_requests"] or not moved:
        raise AssertionError(f"{what}: no orphan migrated: {fc}")
    if not fleet.failed or any(
            "retries exhausted" not in q.error for q in fleet.failed.values()):
        raise AssertionError(f"{what}: no structured failure: {fc}")
    got = [res[r] for r in rids]
    want = [c[:len(g)] if r in fleet.failed else c
            for r, g, c in zip(rids, got, clean)]
    vs = ring_agree(torch, fleet.sub, model, params, prompts, got, want,
                    CHAIN_TOL, what)
    pool_checks(fleet.local, what)
    out = {"fleet_counters": fc, "moved": moved,
           "failed": {r: q.error for r, q in fleet.failed.items()},
           "failed_tokens": {r: len(q.out) for r, q in fleet.failed.items()},
           "ring_failures": [(e.detail["ring"], e.detail["reason"], e.step)
                             for e in fleet.events
                             if e.kind == "ring_failed"],
           "resets_checked_here": box["resets"], "vs_fault_free": vs,
           "rounds": fleet._round, "wall_s": fleet.wall,
           "world_collectives": fleet.world.counters["collectives"]}
    del fleet
    gc.collect()
    return out


def tpf_d(torch, ring, sub, spec):
    """(d): full-width opt-66b in bf16 as 2 rings x tp 2, each rank
    drawing only its shard at its place in its sub-ring; the same 4
    prompts on both rings (one batch each), 128 new: both rings' streams
    equal, kernel 1 exact, replays, peak memory a card."""
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import MultiRingEngine
    import numpy as np
    what = "(17d) opt-66b"
    dev = ring.device
    cfg = tpf_cfg("opt-66b", spec["reduced"])
    plan = ring_plans(cfg, TPF_TP, "bfloat16")[False]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = rank_weights(cfg, plan, sub.rank, dev)
    torch.cuda.synchronize(dev)
    draw_s = time.perf_counter() - t0
    wbytes = weight_bytes(params)
    model = build_model(cfg, plan, dev)
    fleet = MultiRingEngine(model, params, ring, ring_size=TPF_TP,
                            config=EngineConfig(**TPF_D_KW), device=dev,
                            graphs=ring.nccl)
    rng = np.random.RandomState(66)
    base = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=TPF_D_IN)]
            for _ in range(TPF_D_PROMPTS)]
    prompts = [p for p in base for _ in range(2)]
    # warm both rings: a 32-token prompt each (the run's prefill bucket,
    # sampler and window captured), then the run from zero
    fleet.generate([base[0], base[1]], max_new_tokens=2)
    streams, launches, wall = tpf_fleet_run(torch, fleet, prompts,
                                            TPF_D_NEW)
    tpf_fleet_gates(fleet, launches, what)
    ring0, ring1 = streams[0::2], streams[1::2]
    if [fleet.ring_of[r] for r in sorted(fleet.ring_of)][-8:] != \
            [0, 1] * TPF_D_PROMPTS:
        raise AssertionError(f"{what}: routed {fleet.ring_of}")
    if ring0 != ring1 or any(len(s) != TPF_D_NEW for s in streams):
        raise AssertionError(f"{what}: the rings' streams differ on the "
                             "same prompts")
    st = fleet.per_ring_stats()
    tokens = sum(s.tokens for s in st)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    out = {"draw_s": draw_s, "weight_bytes_per_card": wbytes,
           "peak_memory_bytes": peak, "tokens": tokens,
           "fleet_wall_s": wall, "tokens_per_s": tokens / wall,
           "ms_per_token_per_ring": [s.wall * 1e3 / max(s.steps, 1)
                                     for s in st],
           "decode_steps_per_ring": [s.steps for s in st],
           "kernel1_launches": launches,
           "kernel1_want": launches_want(fleet.local),
           "graph_replays": fleet.local.stats.graph_replays,
           "routed": list(fleet.router.routed),
           "streams_equal_across_rings": ring0 == ring1,
           "stream_head": ring0[0][:16],
           **ring_counts(fleet.sub, fleet.local.stats.device_decode_steps)}
    del fleet, model, params
    gc.collect()
    return out


def tpf_fleet_rank(ring, spec):
    """Phase 17 on the mesh fleet of 2 rings x tp 2 (cards 0-3; rank r
    on ``cuda:r``, NCCL, graphs): (a), (b), (c) on full-width opt-1.3b
    f32 (blocking), then (d) opt-66b bf16.  Returns every rank's
    record."""
    import torch
    from repro_torch.core.rings import sub_ring
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import MultiRingEngine
    dev = ring.device
    t_all = time.perf_counter()
    idx, sub = sub_ring(ring, TPF_TP)
    cfg = tpf_cfg("opt-1.3b", spec["reduced"])
    plan = ring_plans(cfg, TPF_TP)[False]
    params = rank_weights(cfg, plan, sub.rank, dev)
    model = build_model(cfg, plan, dev)
    fleet = MultiRingEngine(model, params, ring, ring_size=TPF_TP,
                            config=EngineConfig(**TPF_KW), device=dev,
                            graphs=ring.nccl)
    agreement = fleet.agreement
    prompts = spec["prompts"]
    fleet.generate([p[:8] for p in prompts[:2]], max_new_tokens=2)
    out = {"rank": ring.rank, "card": str(dev), "ring": idx,
           "sub_ranks": sub.ranks, "backend": ring.backend}
    t0 = time.perf_counter()
    out["a"] = tpf_a(torch, fleet, model, params, spec)
    out["a_s"] = time.perf_counter() - t0
    if ring.rank == 0:
        print(f"[tp_fleet] (17a) rank 0: {out['a']['tokens_per_s']:.1f} "
              f"tokens/s over the fleet's wall, routed "
              f"{out['a']['routed']}", flush=True)
    t0 = time.perf_counter()
    out["b"] = tpf_b(torch, ring, model, params, spec, out["a"]["streams"])
    out["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace = tpf_trace(cfg)
    base, bwall, _ = serve_blocking(torch, fleet, trace)
    c = {"blocking": {"tokens": sum(map(len, base)), "wall_s": bwall,
                      "tokens_per_s": sum(map(len, base)) / bwall}}
    c.update(tpf_frontends(torch, ring, sub, fleet, model, params, trace,
                           base, "(17c) fleet"))
    out["c"] = c if ring.rank == 0 else None
    out["c_s"] = time.perf_counter() - t0
    out["agreement"] = dict(agreement.counters)
    out["fleet_rounds"] = fleet._round
    del fleet, model, params
    gc.collect()
    if dev.type == "cuda":
        free_cuda(torch)
    t0 = time.perf_counter()
    out["d"] = tpf_d(torch, ring, sub, spec)
    out["d_s"] = time.perf_counter() - t0
    out["s"] = time.perf_counter() - t_all
    return agreement.gather(out)


def tpf_same(per_rank, get, what):
    vals = [get(r) for r in per_rank]
    if any(v != vals[0] for v in vals):
        raise AssertionError(f"(17) {what}: the ranks differ: {vals}")
    return vals[0]


def run_tp_fleet(torch, dev, card_name, lap=None, device="cuda",
                 reduced=False):
    """Phase 17 on a machine of 4 or more cards: the tp=1 reference on
    ``dev`` (opt-1.3b f32, phase 9's traffic), a lone ring of tp 2 on
    cards 0-1 (:func:`tpf_ring_rank`), then the mesh fleet of 2 rings x
    tp 2 on cards 0-3 (:func:`tpf_fleet_rank`).  ``device="cpu"`` and
    ``reduced`` rehearse the phase on gloo ranks at reduced widths.
    Returns the record."""
    from repro_torch.core.dist import run_ranks
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build_model
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.weights import redraw
    t_phase = time.perf_counter()
    placement = "card_per_rank" if device == "cuda" else None
    cfg = tpf_cfg("opt-1.3b", reduced)
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, dev)
    params = init_params(cfg, plan, seed=0, device=dev)
    redraw(params, opt_std(cfg), OPT_REDRAW_SEED)
    prompts = opt_prompts(cfg)[0]
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    eng = LPUEngine(model, params, EngineConfig(**TPF_KW), device=dev,
                    graphs=dev.type == "cuda")
    want = eng.generate(prompts, max_new_tokens=TPF_NEW)
    on_graphs(eng)
    del eng, model, params
    gc.collect()
    if dev.type == "cuda":
        free_cuda(torch)
    rec = {"card": card_name, "tp": TPF_TP, "rings": TPF_RINGS,
           "tp1_s": time.perf_counter() - t_phase}
    spec = {"prompts": prompts, "want": want, "reduced": reduced}
    t0 = time.perf_counter()
    lone = run_ranks(tpf_ring_rank, TPF_TP, spec, device=device,
                     placement=placement, timeout_s=300)
    rec["lone_ranks_s"] = time.perf_counter() - t0
    tpf_same(lone, lambda x: x["a"]["streams"], "lone ring streams")
    progs = tpf_same(lone, lambda x: x["a"]["programs"],
                     "lone ring programs' collectives")
    la = dict(lone[0]["a"])
    la.pop("streams")
    la["kernel1_launches_per_rank"] = [x["a"]["kernel_launches"]
                                       for x in lone]
    rec["a_lone_ring"] = la
    rec["c_lone_ring"] = lone[0]["c"]
    if lap is not None:
        lap("(17) lone ring")
    spec["lone_programs"] = progs
    t0 = time.perf_counter()
    per_rank = run_ranks(tpf_fleet_rank, TPF_TP * TPF_RINGS, spec,
                         device=device, placement=placement, timeout_s=600)
    rec["fleet_ranks_s"] = time.perf_counter() - t0
    if [x["ring"] for x in per_rank] != [0, 0, 1, 1]:
        raise AssertionError(f"(17) sub-rings {[x['ring'] for x in per_rank]}")
    a = [x["a"] for x in per_rank]
    tpf_same(a, lambda x: (x["streams"], x["routed"], x["per_ring_tokens"]),
             "(a) streams, routes and per-ring tokens")
    ra = {k: v for k, v in a[0].items() if k not in ("streams",)}
    for k in ("kernel1_launches", "kernel1_want", "graph_replays",
              "collectives_per_decode_step", "world_collectives",
              "device_decode_steps", "prefill_chunks"):
        ra[f"{k}_per_rank"] = [x[k] for x in a]
    ra["vs_lone_ring_tokens_per_s"] = la["tokens_per_s"]
    rec["a_fleet"] = ra
    b = [x["b"] for x in per_rank]
    tpf_same(b, lambda x: (x["fleet_counters"], x["moved"], x["failed"],
                           x["ring_failures"]), "(b) fleet counters")
    rb = dict(b[0])
    rb["resets_checked_per_rank"] = [x["resets_checked_here"] for x in b]
    rec["b_chaos"] = rb
    rec["c_fleet"] = per_rank[0]["c"]
    d = [x["d"] for x in per_rank]
    tpf_same(d, lambda x: (x["tokens"], x["routed"], x["stream_head"]),
             "(d) tokens, routes and streams")
    rd = {k: v for k, v in d[0].items()
          if k not in ("peak_memory_bytes", "weight_bytes_per_card",
                       "kernel1_launches", "kernel1_want", "draw_s")}
    for k in ("peak_memory_bytes", "weight_bytes_per_card",
              "kernel1_launches", "kernel1_want", "draw_s"):
        rd[f"{k}_per_rank"] = [x[k] for x in d]
    rd["one_ring_tp2_batch1_ms_per_token"] = dict(
        ms=TPF_ONE_RING_OPT66_MS, source="measured in another run on H100s: "
        "one ring of tp 2, batch 1, blocking, the paper's protocol")
    rec["d_opt66b"] = rd
    rec["agreement_rank0"] = dict(per_rank[0]["agreement"],
                                  fleet_rounds=per_rank[0]["fleet_rounds"])
    rec["part_s_rank0"] = {p: per_rank[0][f"{p}_s"] for p in "abcd"}
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def print_tp_fleet(rec, smi):
    a, la, b, d = (rec["a_fleet"], rec["a_lone_ring"], rec["b_chaos"],
                   rec["d_opt66b"])
    print(f"[tp_fleet] (17a) opt-1.3b f32 blocking, 8 x {TPF_NEW}: fleet of "
          f"{TPF_RINGS} x tp {TPF_TP} {a['tokens_per_s']:.1f} tokens/s over "
          f"the fleet's wall (lone ring of tp {TPF_TP} "
          f"{la['tokens_per_s']:.1f}), routed {a['routed']}, equal to tp=1 "
          f"{a['vs_tp1']['equal']}/{a['vs_tp1']['of']}, kernel 1 "
          f"{a['kernel1_launches_per_rank']} (want "
          f"{a['kernel1_want_per_rank']}), collectives per decode step "
          f"{a['collectives_per_decode_step_per_rank']} (lone ring "
          f"{la['collectives_per_decode_step']:.2f}), world-group "
          f"collectives {a['world_collectives_per_rank']} | {smi}")
    print(f"[tp_fleet] (17b) chaos {TPF_CHAOS}: {b['fleet_counters']}, "
          f"moved {b['moved']}, failed {sorted(b['failed'])}, ring failures "
          f"{b['ring_failures']}, resets checked "
          f"{b['resets_checked_per_rank']}, survivors "
          f"{b['vs_fault_free']['equal']}/{b['vs_fault_free']['of']} | "
          f"{smi}")
    for where, c in (("lone ring", rec["c_lone_ring"]),
                     ("fleet", rec["c_fleet"])):
        for key in ("budget_off", "budget_on"):
            r = c[key]
            print(f"[tp_fleet] (17c) {where} {key}: ttft from arrival "
                  f"p50/p99 {r['ttft_arrival_ms_p50']:.1f}/"
                  f"{r['ttft_arrival_ms_p99']:.1f} ms, ms/token p50/p99 "
                  f"{r['ms_per_token_p50']:.2f}/{r['ms_per_token_p99']:.2f},"
                  f" {r['tokens_per_s']:.1f} tokens/s (blocking "
                  f"{c['blocking']['tokens_per_s']:.1f}), rejected "
                  f"{r['rejected']}, orders crc {r['orders_crc']} x "
                  f"{r['orders_applied']} on every rank | {smi}")
    print(f"[tp_fleet] (17d) opt-66b bf16 {TPF_RINGS} x tp {TPF_TP}: "
          f"{d['tokens_per_s']:.1f} tokens/s over the fleet's wall, ms/token "
          f"per ring {[round(x, 3) for x in d['ms_per_token_per_ring']]} at "
          f"4 slots, peak memory per card "
          f"{[round(x / 1e9, 2) for x in d['peak_memory_bytes_per_rank']]} "
          f"GB (weights {d['weight_bytes_per_card_per_rank'][0] / 1e9:.2f}),"
          f" kernel 1 {d['kernel1_launches_per_rank']} (want "
          f"{d['kernel1_want_per_rank']}); the single ring at tp 2, batch "
          f"1 (another run): {TPF_ONE_RING_OPT66_MS} ms/token | {smi}")
    print(f"[tp_fleet] agreement on rank 0: {rec['agreement_rank0']}; "
          f"phase {rec['phase_s']:.1f} s")



# ---------------------------------------------------------------------------
# phase 18: the data axis for serving, a (data, model) grid (4 cards)
# ---------------------------------------------------------------------------

DA_SHAPE = (2, 2)              # data x model: rank (d, m) on cuda:(2d + m)
# (a): opt-1.3b f32 full width, batch 8 over data, 32 in, 32 serve steps
DA_A = dict(batch=8, prompt=32, new=32, max_seq=128)
# (b): jamba-v0.1-52b full width with its KV over data.  f32, one
# super-block: a prompt of 8190 tokens and 8 greedy steps across the
# shard boundary at 8192; bf16, all 32 layers at long_500k (524288
# positions, batch 1): 64 timed steps after a 32-token prompt and 2
# warm-up steps, 16 more under torch.profiler
DA_B_F32 = dict(depth=8, max_seq=16384, prompt=8190, new=8)
DA_B_BF16 = dict(max_seq=524288, prompt=32, warm=2, steps=64, profile=16)
# (c): llama4-maverick full width, experts over data x model: f32, 2
# layers (one dense, one MoE), 4 rows of 16 tokens x 8 new; bf16, 8
# layers, 4 rows, 32 timed steps
DA_C_F32 = dict(depth=2, batch=4, prompt=16, new=8, max_seq=64)
DA_C_BF16 = dict(depth=8, batch=4, prompt=32, warm=2, steps=32, profile=8,
                 max_seq=128)
# the reckoned bounds of (b)'s bf16 token (ISSUE's arithmetic at 3.35
# TB/s: ~31 GB a card on the grid, ~56 GB at tp 2 without a data axis)
DA_RECKONED_MS = {"grid": 9.3, "tp2_twin": 16.7}


def da_cfg(name, depth=None, reduced=False):
    """Full-width ``name`` cut to ``depth`` layers, or (a rehearsal on the
    CPU) its reduced config."""
    from repro_torch.configs import get_config
    if reduced:
        cfg = get_config(name).reduced()
        return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, depth)) \
            if depth else cfg
    return fam_cfg(name, depth)


def da_plan(cfg, grid, dtype, kv_seq=False):
    """The serving plan on the grid (``grid`` True, ESL overlap) or on
    its twin, the model ring of the grid's tp (no data axis)."""
    from repro_torch.compiler.mapper import plan_model
    axes, shape = ((("data", "model"), DA_SHAPE) if grid
                   else (("model",), (DA_SHAPE[1],)))
    return plan_model(cfg, axes, shape, "serve", esl_overlap=True,
                      kv_seq_axis="data" if kv_seq and grid else None,
                      remat="none", compute_dtype=dtype, param_dtype=dtype)


def da_prompts(cfg, batch, length, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    return rng.randint(1, cfg.vocab_size, size=(batch, length)).tolist()


def da_gap(torch, ring, model, params, prefix, max_seq):
    """The top-2 gap of the logits that pick the token after ``prefix``,
    from the model's own prefill on this ring or grid (every rank calls
    it alike; the vocab columns gathered whole)."""
    from repro_torch.core import dist as D
    env = D.make_axis_env(model.plan, batch=1, ring=ring)
    cache = model.init_cache(1, max_seq, env=env)
    with torch.no_grad():
        lg, _ = model.forward(params, torch.tensor([prefix],
                                                   device=ring.device),
                              mode="prefill", cache=cache, env=env)
    row = lg[:, -1].float().contiguous()
    if env.tp > 1:
        row = D.all_gather(row, env.model, dim=-1)
    return float(top2_gap(row)[0])


def da_agree(torch, ring, model, params, prompts, got, want, max_seq, what):
    """Each row's stream ``got`` equal to ``want``, or first apart where
    this model's top-2 gap is at most CHAIN_TOL (a near tie).  Raises
    otherwise."""
    parts = []
    for b, (p, x, y) in enumerate(zip(prompts, got, want)):
        at = next((j for j, (u, v) in enumerate(zip(x, y)) if u != v), None)
        if at is None:
            continue
        gap = da_gap(torch, ring, model, params, list(p) + list(x[:at]),
                     max_seq)
        if gap > CHAIN_TOL:
            raise AssertionError(f"{what}: row {b} differs at token {at} "
                                 f"where the top-2 gap is {gap} > "
                                 f"{CHAIN_TOL}")
        parts.append({"row": b, "at": at, "top2_gap": gap})
    return {"equal": len(prompts) - len(parts), "of": len(prompts),
            "diverged_at_near_ties": parts}


def da_streams(torch, ring, model, params, prompts, new, max_seq):
    """The serving steps (``core/steps.py``) on this rank: the prefill
    step on ``prompts`` (B, P), then ``new`` serve steps of the greedy
    tokens.  Returns (each row's stream: the prefill's token and each
    step's, {kernel 5's launches over the run, the data ring's
    collectives per serve step, prefills, serve steps})."""
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    from repro_torch.kernels import read_launches, reset_launches
    dev = ring.device
    B, P = len(prompts), len(prompts[0])
    pre, meta = build_prefill_step(model, ring, B, max_seq)
    serve, _ = build_serve_step(model, ring, B, max_seq)
    env = meta["env"]
    cache = model.init_cache(B, max_seq, env=env)
    tokens = torch.tensor(prompts, device=dev)
    data = env.data.counters if env.data is not None else None
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
    sync(dev)
    reset_launches()
    with torch.no_grad():
        tok, cache = pre(params, cache, tokens)
        got = [tok]
        per_step = []
        for i in range(new):
            before = data["collectives"] if data else 0
            pos = torch.full((B,), P + i, dtype=torch.int32, device=dev)
            tok, cache = serve(params, cache, tok[:, None].long(), pos)
            per_step.append((data["collectives"] if data else 0) - before)
            got.append(tok)
    sync(dev)
    streams = torch.stack(got, 1).tolist()
    return streams, {"kernel5_launches": read_launches()["mamba_scan_fused"],
                     "data_collectives_per_step": per_step,
                     "prefills": 1, "serve_steps": new,
                     "dp": list(env.dp), "kv_seq_width": env.kv_seq_width}


def da_timed(torch, ring, model, params, prompts, knobs):
    """ms per serve step over ``knobs["steps"]`` timed steps (after the
    prefill and ``warm`` warm-up steps), and the device ms a step of
    ``profile`` more under torch.profiler (NCCL's kernels apart); kernel
    5's launches over the whole run; the bytes a step reads on this card
    (the rank's weights, its KV cache and twice its recurrent states)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    from repro_torch.kernels import read_launches, reset_launches
    dev = ring.device
    B, P = len(prompts), len(prompts[0])
    max_seq = knobs["max_seq"]
    pre, meta = build_prefill_step(model, ring, B, max_seq)
    serve, _ = build_serve_step(model, ring, B, max_seq)
    cache = model.init_cache(B, max_seq, env=meta["env"])
    reset_launches()
    pos = [P]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)

    def step(tok):
        p = torch.full((B,), pos[0], dtype=torch.int32, device=dev)
        pos[0] += 1
        return serve(params, cache, tok[:, None].long(), p)[0]
    with torch.no_grad():
        tok, _ = pre(params, cache, torch.tensor(prompts, device=dev))
        for _ in range(knobs["warm"]):
            tok = step(tok)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(knobs["steps"]):
            tok = step(tok)
        sync(dev)
        wall = time.perf_counter() - t0
        # (the CPU rehearsal's profile records the host: no device time)
        with profile(activities=[ProfilerActivity.CUDA
                                 if dev.type == "cuda"
                                 else ProfilerActivity.CPU]) as prof:
            for _ in range(knobs["profile"]):
                tok = step(tok)
            sync(dev)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    nccl = sum(e.self_device_time_total for e in kernels
               if "nccl" in e.key.lower()) / 1e3
    n = knobs["profile"]
    want = n_scan_layers(model.cfg) * (1 + knobs["warm"] + knobs["steps"]
                                       + n) if dev.type == "cuda" else 0
    kv = sum(t.numel() * t.element_size() for c in cache.values()
             if "k" in c for t in c.values())
    state = 2 * sum(t.numel() * t.element_size() for c in cache.values()
                    if "ssm" in c for t in c.values())
    wb = tree_bytes(params)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"ms_per_step": wall * 1e3 / knobs["steps"],
            "device_ms_per_step": busy / n, "nccl_ms_per_step": nccl / n,
            "batch": B, "positions": [P, pos[0]], "max_seq": max_seq,
            "kernel5_launches": read_launches()["mamba_scan_fused"],
            "kernel5_want": want,
            "weight_bytes": wb, "kv_bytes": kv, "state_bytes_per_step": state,
            "bytes_per_step": wb + kv + state,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def da_run(torch, ring, spec, part, grid):
    """One part of phase 18 at this rank, on the grid or on its twin
    (the model ring of tp 2 on cards 0-1): the rank's shard drawn alone,
    the part's runs, the model freed."""
    from repro_torch.models.registry import build_model
    from repro_torch.weights import init_shard
    dev = ring.device
    cuda = dev.type == "cuda"
    red = spec["reduced"]
    rec = {}
    for key, name, knobs, dtype, kv_seq in spec["parts"][part]:
        cfg = da_cfg(name, knobs.get("depth"), red)
        plan = da_plan(cfg, grid, dtype, kv_seq)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_shard(cfg, plan, ring, seed=0, device=dev)
        if name.startswith("opt"):
            from repro_torch.weights import redraw_shard
            redraw_shard(params, cfg, plan, ring.rank, opt_std(cfg),
                         OPT_REDRAW_SEED)
        r = {"draw_s": time.perf_counter() - t0,
             "weight_bytes": tree_bytes(params),
             "expert_axes": list(plan.moe.expert_axes) if plan.moe else None}
        if cuda:
            # the draw's peak (a part of a tp=1 layer drawn whole) apart
            # from the serving's
            torch.cuda.synchronize(dev)
            r["draw_s"] = time.perf_counter() - t0
            r["draw_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            free_cuda(torch)
            torch.cuda.reset_peak_memory_stats(dev)
        model = build_model(cfg, plan, dev)
        prompts = spec["prompts"][key]
        t0 = time.perf_counter()
        if "steps" in knobs:
            r.update(da_timed(torch, ring, model, params, prompts, knobs))
            if r["kernel5_launches"] != r["kernel5_want"]:
                raise AssertionError(
                    f"(18) {key} rank {ring.rank}: kernel 5 launched "
                    f"{r['kernel5_launches']} != {r['kernel5_want']}")
        else:
            streams, counts = da_streams(torch, ring, model, params, prompts,
                                         knobs["new"], knobs["max_seq"])
            r.update(counts, streams=streams)
            # on the CPU the wrappers run their plain versions: no launch
            want = n_scan_layers(cfg) * (1 + knobs["new"]) \
                if cfg.family == "hybrid" and cuda else 0
            if counts["kernel5_launches"] != want:
                raise AssertionError(
                    f"(18) {key} rank {ring.rank}: kernel 5 launched "
                    f"{counts['kernel5_launches']} != {want}")
            r["kernel5_want"] = want
            for other in ("twin", "tp1"):
                ref = spec.get(other, {}).get(key)
                if grid and ref is not None:
                    r[f"vs_{other}"] = da_agree(
                        torch, ring, model, params, prompts, streams, ref,
                        knobs["max_seq"], f"(18) {key} grid vs {other}")
        r["run_s"] = time.perf_counter() - t0
        r["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                  if cuda else 0)
        rec[key] = r
        del model, params
        gc.collect()
        if cuda:
            free_cuda(torch)
        if ring.rank == 0:
            print(f"[data_axis] (18{part}) {key} on the "
                  f"{'grid' if grid else 'tp 2 twin'}: draw "
                  f"{r['draw_s']:.1f} s, run {r['run_s']:.1f} s", flush=True)
    return rec


def da_grid_rank(ring, spec):
    """One rank of phase 18's grid (rank (d, m) on cuda:(2d + m), NCCL,
    eager): kernel 5's fused entry against its plain version at the
    rank's shapes, then (a), (b), (c); returns every rank's record."""
    import torch
    out = {"rank": ring.rank, "device": str(ring.device)}
    if ring.device.type == "cuda":
        out["kernel5_at_rank"] = kernel5_at_rank(torch, ring.device,
                                                 spec["k5_shapes"], 70)
    for part in ("a", "b", "c"):
        out[part] = da_run(torch, ring, spec, part, True)
    return ring.gather_object(out)


def da_twin_rank(ring, spec):
    """One rank of the grid's twin: the model ring of tp 2 (cards 0-1),
    the parts that have a twin; returns every rank's record."""
    import torch
    out = {"rank": ring.rank}
    for part in ("a", "b", "c"):
        if spec["parts"].get(part):
            out[part] = da_run(torch, ring, spec, part, False)
    return ring.gather_object(out)


def da_tp1(torch, dev, prompts, reduced):
    """(a)'s tp=1 streams on ``dev``: the same weights through the
    serving steps without a mesh."""
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build_model
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.weights import redraw
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    cfg = da_cfg("opt-1.3b", reduced=reduced)
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, dev)
    params = init_params(cfg, plan, seed=0, device=dev)
    redraw(params, opt_std(cfg), OPT_REDRAW_SEED)
    B, P = len(prompts), len(prompts[0])
    pre, _ = build_prefill_step(model, None, B, DA_A["max_seq"])
    serve, _ = build_serve_step(model, None, B, DA_A["max_seq"])
    cache = model.init_cache(B, DA_A["max_seq"])
    with torch.no_grad():
        tok, cache = pre(params, cache, torch.tensor(prompts, device=dev))
        got = [tok]
        for i in range(DA_A["new"]):
            tok, cache = serve(params, cache, tok[:, None].long(),
                               torch.full((B,), P + i, dtype=torch.int32,
                                          device=dev))
            got.append(tok)
    out = torch.stack(got, 1).tolist()
    del model, params, cache
    gc.collect()
    return out


def check_time_grid_k5(torch, dev, card_name, shape):
    """Kernel 5's fused entry at a grid rank's decode shape on ``dev``:
    against its plain version and timed beside it, with its bound."""
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_fused_ref
    from repro_torch.kernels import held_launches
    args = mamba_fused_inputs(torch, dev, shape, 91)
    with held_launches():
        got = mamba_scan_fused(*args)
        want = mamba_scan_fused_ref(*args)
        torch.cuda.synchronize(dev)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        if err > MAMBA_TOL:
            raise AssertionError(f"(18) mamba_scan_fused {shape}: max abs "
                                 f"{err} > {MAMBA_TOL}")
        per_set = 4 * sum(a.numel() for a in args)
        sets = [tuple(a.clone() for a in args)
                for _ in range(sets_for(per_set))]
        t = timed(torch, {"ms": lambda i: mamba_scan_fused(*sets[i]),
                          "plain_ms": lambda i: mamba_scan_fused_ref(
                              *sets[i])}, len(sets))
    t["bound_ms"], t["bound_by"] = mamba_fused_bound(shape, card_name)
    t.update(max_abs_err=err, shape=list(shape), library_ms=None)
    return t


def run_data_axis(torch, dev, card_name, lap=None, device="cuda",
                  reduced=False):
    """Phase 18 on a machine of 4 or more cards: kernel 5 at a grid
    rank's shape on ``dev``; (a)'s tp=1 streams on ``dev``; the twin
    (the model ring of tp 2 on cards 0-1) for (a), (b) and (c)'s f32
    streams and (b)'s bf16 long context; then the grid of data 2 x
    model 2 on cards 0-3 for every part, each stream held to the
    twin's and (a)'s to tp=1's.  ``device="cpu"`` and ``reduced``
    rehearse the phase on gloo ranks at reduced widths (the timed runs
    a few steps long).  Returns the record."""
    from repro_torch.core.dist import run_ranks
    t_phase = time.perf_counter()
    placement = "card_per_rank" if device == "cuda" else None
    # a rank draws a giant MoE's expert part of a tp=1 layer whole (in
    # f32: ~21 GB for llama4's) beside its shard; segments that grow keep
    # the allocator's cache from fragmenting under it (a fixed-segment
    # cache left 16 GB reserved and unusable and the draw out of memory)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    cards = smi_query("--query-gpu=index,name,power.limit",
                      "--format=csv,noheader").splitlines() \
        if device == "cuda" else []
    rec = {"card": card_name, "shape": list(DA_SHAPE), "cards_listed": cards}
    b_f32 = dict(DA_B_F32, prompt=30, max_seq=64) if reduced else DA_B_F32
    a = dict(DA_A, prompt=8) if reduced else DA_A
    jamba_c = da_cfg("jamba-v0.1-52b", reduced=reduced)
    d_inner = jamba_c.mamba.expand * jamba_c.d_model // DA_SHAPE[1]
    k5 = [(1, 1, d_inner, jamba_c.mamba.d_state),
          (1, b_f32["prompt"], d_inner, jamba_c.mamba.d_state)]
    if device == "cuda":
        rec["kernel5"] = check_time_grid_k5(torch, dev, card_name, k5[0])
    opt = da_cfg("opt-1.3b", reduced=reduced)
    llama = da_cfg("llama4", reduced=reduced)
    prompts = {"opt": da_prompts(opt, a["batch"], a["prompt"], 0),
               "jamba_f32": da_prompts(jamba_c, 1, b_f32["prompt"], 1),
               "jamba_bf16": da_prompts(jamba_c, 1, 8 if reduced else
                                        DA_B_BF16["prompt"], 2),
               "llama4_f32": da_prompts(llama, DA_C_F32["batch"],
                                        DA_C_F32["prompt"], 3),
               "llama4_bf16": da_prompts(llama, DA_C_BF16["batch"],
                                         8 if reduced else
                                         DA_C_BF16["prompt"], 4)}
    t0 = time.perf_counter()
    tp1 = {"opt": da_tp1(torch, dev, prompts["opt"], reduced)}
    rec["tp1_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        free_cuda(torch)
    full = {"a": [("opt", "opt-1.3b", a, "float32", False)],
            "b": [("jamba_f32", "jamba-v0.1-52b", b_f32, "float32", True)],
            "c": [("llama4_f32", "llama4", DA_C_F32, "float32", False)]}
    b_bf16, c_bf16 = DA_B_BF16, DA_C_BF16
    if reduced:
        b_bf16 = dict(b_bf16, max_seq=64, prompt=8, warm=1, steps=3,
                      profile=2)
        c_bf16 = dict(c_bf16, prompt=8, warm=1, steps=3, profile=2)
    full["b"].append(("jamba_bf16", "jamba-v0.1-52b", b_bf16, "bfloat16",
                      True))
    full["c"].append(("llama4_bf16", "llama4", c_bf16, "bfloat16", False))
    twin_parts = {k: [p for p in v if p[0] != "llama4_bf16"]
                  for k, v in full.items()}
    spec = {"prompts": prompts, "reduced": reduced, "parts": twin_parts}
    t0 = time.perf_counter()
    twin = run_ranks(da_twin_rank, DA_SHAPE[1], spec, device=device,
                     placement=placement, timeout_s=900)
    rec["twin_s"] = time.perf_counter() - t0
    if lap is not None:
        lap("(18) tp 2 twin")
    for part in ("a", "b", "c"):
        for key, r in twin[0][part].items():
            if "streams" in r and r["streams"] != twin[1][part][key][
                    "streams"]:
                raise AssertionError(f"(18) twin {key}: ranks disagree")
    twin_streams = {k: r["streams"] for part in ("a", "b", "c")
                    for k, r in twin[0][part].items() if "streams" in r}
    spec = dict(spec, parts=full, twin=twin_streams, tp1=tp1,
                k5_shapes=k5)
    t0 = time.perf_counter()
    grid = run_ranks(da_grid_rank, DA_SHAPE[0] * DA_SHAPE[1], spec,
                     device=device, placement=placement, timeout_s=1200)
    rec["grid_s"] = time.perf_counter() - t0
    if lap is not None:
        lap("(18) grid")
    for part in ("a", "b", "c"):
        for key in grid[0][part]:
            rs = [g[part][key] for g in grid]
            if "streams" in rs[0] and any(r["streams"] != rs[0]["streams"]
                                          for r in rs):
                raise AssertionError(f"(18) grid {key}: ranks disagree")
            out = {k: v for k, v in rs[0].items()
                   if k not in ("streams", "peak_memory_bytes",
                                "weight_bytes", "kernel5_launches",
                                "draw_s", "top_kernels", "draw_peak_bytes")}
            for k in ("peak_memory_bytes", "draw_peak_bytes",
                      "weight_bytes", "kernel5_launches", "draw_s",
                      "ms_per_step", "device_ms_per_step",
                      "nccl_ms_per_step"):
                if k in rs[0]:
                    out[f"{k}_per_rank"] = [r[k] for r in rs]
            out["top_kernels_rank0"] = rs[0].get("top_kernels")
            out["stream_head"] = rs[0]["streams"][0][:16] \
                if "streams" in rs[0] else None
            tw = twin[0].get(part, {}).get(key)
            if tw is not None:
                out["twin"] = {k: v for k, v in tw.items()
                               if k not in ("streams",)}
                out["twin"]["peak_memory_bytes_per_rank"] = [
                    t[part][key].get("peak_memory_bytes") for t in twin]
            rec[f"{part}_{key}"] = out
    a_rec = rec["a_opt"]
    if set(map(tuple, [r["a"]["opt"]["data_collectives_per_step"]
                       for r in grid])) != {(1,) * a["new"]}:
        raise AssertionError("(18a) the data axis must add one all-gather a "
                             "step: " + str([r["a"]["opt"][
                                 "data_collectives_per_step"] for r in grid]))
    a_rec["data_all_gathers_per_step"] = 1
    rec["kernel5_at_rank_per_rank"] = [g.get("kernel5_at_rank")
                                       for g in grid]
    rec["kernel5_grid_launches"] = sum(
        r[part][key]["kernel5_launches"] for r in grid
        for part in ("b",) for key in r[part])
    bf = rec.get("b_jamba_bf16")
    if bf is not None:
        bw = bandwidth_for(card_name)
        for who, r in (("grid", bf), ("tp2_twin", bf["twin"])):
            r["bound_ms_per_token"] = r["bytes_per_step"] / bw * 1e3
            r["reckoned_bound_ms"] = DA_RECKONED_MS[who]
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def print_data_axis(rec, smi):
    a, bf = rec["a_opt"], rec["b_jamba_f32"]
    print(f"[data_axis] (18a) opt-1.3b f32 batch 8 on data {DA_SHAPE[0]} x "
          f"model {DA_SHAPE[1]}: equal to tp 1 {a['vs_tp1']['equal']}/"
          f"{a['vs_tp1']['of']}, to the tp 2 ring {a['vs_twin']['equal']}/"
          f"{a['vs_twin']['of']} (near ties "
          f"{a['vs_twin']['diverged_at_near_ties']}), data all-gathers a "
          f"step {a['data_all_gathers_per_step']} | {smi}")
    print(f"[data_axis] (18b) jamba f32 one super-block, KV over data, "
          f"{DA_B_F32['prompt']} + {DA_B_F32['new']}: equal to the tp 2 twin "
          f"{bf['vs_twin']['equal']}/{bf['vs_twin']['of']} "
          f"({bf['vs_twin']['diverged_at_near_ties']}), kernel 5 "
          f"{bf['kernel5_launches_per_rank']} (want {bf['kernel5_want']}) | "
          f"{smi}")
    for key in ("b_jamba_bf16", "c_llama4_bf16"):
        r = rec.get(key)
        if r is None:
            continue
        peak = [round(x / 1e9, 2) for x in r["peak_memory_bytes_per_rank"]]
        line = (f"[data_axis] {key}: grid "
                f"{r['ms_per_step_per_rank'][0]:.3f} ms/step wall, "
                f"{r['device_ms_per_step_per_rank'][0]:.3f} device (NCCL "
                f"{r['nccl_ms_per_step_per_rank'][0]:.3f}), peak {peak} GB "
                f"serving, weights {r['weight_bytes_per_rank'][0] / 1e9:.2f}"
                " GB a card")
        if "bound_ms_per_token" in r:
            t = r["twin"]
            tpeak = [round(x / 1e9, 2)
                     for x in t["peak_memory_bytes_per_rank"]]
            line += (f", bound {r['bound_ms_per_token']:.3f} (reckoned "
                     f"{r['reckoned_bound_ms']}); tp 2 twin "
                     f"{t['ms_per_step']:.3f} ms/step wall, "
                     f"{t['device_ms_per_step']:.3f} device, bound "
                     f"{t['bound_ms_per_token']:.3f} (reckoned "
                     f"{t['reckoned_bound_ms']}), peak {tpeak} GB serving,"
                     f" weights {t['weight_bytes'] / 1e9:.2f} GB")
        print(line + f" | {smi}")
    c = rec["c_llama4_f32"]
    print(f"[data_axis] (18c) llama4 f32 2 layers, experts "
          f"{c['expert_axes']}: equal to the tp 2 twin "
          f"{c['vs_twin']['equal']}/{c['vs_twin']['of']} | {smi}")
    print(f"[data_axis] phase {rec['phase_s']:.1f} s (twin "
          f"{rec['twin_s']:.1f}, grid {rec['grid_s']:.1f})")


# ---------------------------------------------------------------------------
# phase 19: training on the mesh (4 or more cards)
# ---------------------------------------------------------------------------

TM_SHAPE = (2, 2)              # data x model: rank (d, m) on cuda:(2d + m)
TM_NAME = "opt-6.7b"
TM_A = dict(depth=4, batch=8, seq=512, steps=3, lr=3e-4)
# (a)'s gates, each a share of a leaf's max: step 1's gradients, and
# the parameters after the last step (at most 1e-3 of a leaf's elements
# past it).  float64 holds the grid to the twin's values to its own
# rounding (tools/train_mesh_probe).  float32's rounding at these shapes
# reaches 1.6e-3 of l0's mlp/wi on an H100 (the grid's sums, split over
# data and model, round apart from the twin's, and 4 layers of backward
# amplify it; AdamW's m / sqrt(v) then moves most of a bias leaf's
# elements apart), so its gradient gate only catches a share dropped or
# counted twice (order 1) and its parameters' share is recorded at 1e-5
TM_EXACT = {"float64": dict(grads=1e-9, params=1e-9),
            "float32": dict(grads=1e-2, params=None)}
TM_B = dict(batch=8, seq=2048, steps=20, lr=3e-4, warm=2)
TM_C = dict(steps=8, ckpt_every=4, crash=6, batch=8, seq=512, lr=3e-4)
# PERF.md's reckoning for (b), written before the first call
TM_RECKONED = {"state_gb_per_card": 26.6, "data_ring_recv_gb_per_step": 13.0,
               "peak_gb_per_card": (35.0, 50.0), "flops_per_step": 8.7e14,
               "ms_at_peak": 220.0}


class FirstGrads:
    """AdamW that keeps a copy of the gradients of its first update."""

    def __init__(self, opt):
        self.opt, self.first = opt, None

    def apply(self, params, grads, state, norm_sq):
        if self.first is None:
            from repro_torch.tree import tree_map
            self.first = tree_map(lambda g: g.detach().clone(), grads)
        return self.opt.apply(params, grads, state, norm_sq=norm_sq)


def tm_cfg(depth=None, reduced=False):
    from repro_torch.configs import get_config
    cfg = get_config(TM_NAME)
    if reduced:
        return cfg.reduced()
    return dataclasses.replace(cfg, n_layers=depth) if depth else cfg


def tm_plan(cfg, shape, **kw):
    from repro_torch.compiler.mapper import plan_model
    axes = None if shape is None else (
        ("model",) if len(shape) == 1 else ("data", "model"))
    return plan_model(cfg, axes, shape or (1,), "train", **kw)


def tm_batches(cfg, batch, seq, steps, rows=(0, 1)):
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(cfg.vocab_size, seq, seed=0)
    return [data.batch(i, batch, rows) for i in range(steps)]


def tm_on(torch, b, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def vocab_rows(tree, cfg):
    """``tree``'s leaves by path, the tied embedding's padded vocab rows
    (an untied head's columns) cut: a relayout zero-fills them, an init
    draws them, and no loss reads them."""
    from repro_torch.weights import _leaves
    out = {}
    for path, t in _leaves(tree):
        if path == "embed" and cfg.tie_embeddings:
            t = t[:cfg.vocab_size]
        elif path == "head":
            t = t[..., :cfg.vocab_size]
        out[path] = t
    return out


def float64_process():
    """Make this spawned rank compute every float in float64: the
    model's ``.float()`` casts, ``.to(torch.float32)`` and float32
    allocations give float64, so (19a)'s float64 run has no float32
    rounding anywhere.  For a rank process only: it changes torch for
    the whole process."""
    import torch
    f32, f64 = torch.float32, torch.float64
    torch.set_default_dtype(f64)
    torch.Tensor.float = lambda self, *a, **k: self.double()
    to = torch.Tensor.to

    def to64(self, *a, **k):
        a = tuple(f64 if x is f32 else x for x in a)
        if k.get("dtype") is f32:
            k["dtype"] = f64
        return to(self, *a, **k)
    torch.Tensor.to = to64
    for name in ("zeros", "ones", "full", "empty"):
        make = getattr(torch, name)

        def made(*a, _make=make, **k):
            if k.get("dtype") is f32:
                k["dtype"] = f64
            return _make(*a, **k)
        setattr(torch, name, made)


def leaf_err(torch, got, want):
    """{path: max |got - want| / max |want|} over two trees of tensors."""
    from repro_torch.weights import _leaves
    w = dict(_leaves(want))
    out = {}
    for path, g in _leaves(got):
        ref = w[path].float()
        scale = float(ref.abs().max()) or 1.0
        out[path] = float((g.float().to(ref.device) - ref).abs().max()) / scale
    return out


def adam_err(torch, got, want, skip, tol=1e-5):
    """Parameters after AdamW steps against their twin's: ({path: the
    share of the leaf's elements past ``tol`` x its max}, the largest
    |got - want| over every element).  AdamW moves an element by up to
    lr a step whatever its gradient's size, so an element whose gradient
    is rounding may step the other way (the gradients are gated
    strictly)."""
    from repro_torch.weights import _leaves
    w = dict(_leaves(want))
    out, worst = {}, 0.0
    for path, p in _leaves(got):
        if path in skip:
            continue
        ref = w[path].float()
        d = (p.float().to(ref.device) - ref).abs()
        scale = float(ref.abs().max()) or 1.0
        out[path] = float((d > tol * scale).float().mean())
        worst = max(worst, float(d.max()))
    return out, worst


def replica_crcs(ring, env, plan, params):
    """For every leaf replicated over a ring of the grid, whether its
    bits (crc32) are the same on every rank of that ring."""
    import torch
    from repro_torch.weights import _leaves, mesh_axes_of
    out = {}
    for path, t in _leaves(params):
        axes = mesh_axes_of(path, plan)
        for name in ("data", "model"):
            r = env.axis(name)
            if r is None or r.size < 2 or name in axes:
                continue
            crc = zlib.crc32(t.detach().cpu().contiguous().view(torch.uint8)
                             .numpy().tobytes())
            got = r.gather_object(crc)
            out[f"{path}@{name}"] = all(c == got[0] for c in got)
    return out


def tm_twin_rank(ring, spec):
    """(a) one rank of the grid in ``spec["dtype"]``: the 3 steps, step
    1's gradients and the final parameters gathered to the host and
    relaid to tp=1 (kept on rank 0), the replicated leaves' bits; then
    rank 0 runs the tp=1 twin on its own card and compares (the padded
    vocab rows cut).  Returns rank 0's record."""
    import torch
    from repro_torch.core.steps import build_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW, get_schedule
    from repro_torch.weights import (_leaves, gather_shard, init_shard,
                                     relayout, tp1_plan)
    dt = spec["dtype"]
    if dt == "float64":
        float64_process()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a, dev = spec["a"], ring.device
    cfg = tm_cfg(a["depth"], spec["reduced"])
    kw = dict(esl_overlap=False, remat="none", compute_dtype=dt,
              param_dtype=dt)
    plan = tm_plan(cfg, TM_SHAPE, **kw)
    plan1 = tp1_plan(cfg, plan)
    model = build_model(cfg, plan, dev)
    opt = FirstGrads(AdamW(lr=get_schedule("cosine", a["lr"], 1,
                                           a["steps"])))
    params = init_shard(cfg, plan, ring.rank, 0, device=dev)
    state = opt.opt.init(params)
    step, meta = build_train_step(model, opt, ring, a["batch"])
    env = meta["env"]
    # the grid's step takes its data row's rows; the twin the whole batch
    mine = tm_batches(cfg, a["batch"], a["seq"], a["steps"],
                      (env.data.rank, env.dp_width))
    losses, gnorms, walls = [], [], []
    for b in mine:
        t = time.perf_counter()
        params, state, m = step(params, state, tm_on(torch, b, dev))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        walls.append(time.perf_counter() - t)
    keep = ring.rank == 0
    g1 = gather_shard(opt.first, plan, env, to="cpu")
    g1 = relayout(g1, cfg, plan, plan1) if keep else None
    p3 = gather_shard(params, plan, env, to="cpu")
    p3 = relayout(p3, cfg, plan, plan1) if keep else None
    replicas = replica_crcs(ring, env, plan, params)
    del params, state, opt
    free_cuda(torch) if dev.type == "cuda" else gc.collect()
    out = {"dtype": dt, "grid_losses": losses, "grid_grad_norms": gnorms,
           "grid_walls_s": walls, "replicas_bit_equal": replicas}
    if keep:
        model1 = build_model(cfg, plan1, dev)
        opt1 = FirstGrads(AdamW(lr=get_schedule("cosine", a["lr"], 1,
                                                a["steps"])))
        params1 = model1.init(0)
        state1 = opt1.opt.init(params1)
        step1, _ = build_train_step(model1, opt1, None, a["batch"])
        l1, n1 = [], []
        for b in tm_batches(cfg, a["batch"], a["seq"], a["steps"]):
            params1, state1, m = step1(params1, state1, tm_on(torch, b, dev))
            l1.append(float(m["loss"]))
            n1.append(float(m["grad_norm"]))
        # a leaf whose tp=1 gradient is below 1e-6 x the tree's largest
        # is round-off of a zero gradient (OPT's key bias: it adds one
        # constant to a query's scores, which the softmax ignores); its
        # gate is that the grid's is too.  AdamW moves an element by up
        # to lr a step whatever its gradient's size, so an element whose
        # gradient is rounding may step the other way: every one within
        # 2 x lr a step
        top = max(float(g.abs().max()) for _, g in _leaves(opt1.first))
        noise = {p for p, g in _leaves(opt1.first)
                 if float(g.abs().max()) < 1e-6 * top}
        grid_noise = {p: float(g.abs().max()) / top
                      for p, g in _leaves(g1) if p in noise}
        ge = {k: v for k, v in leaf_err(torch, vocab_rows(g1, cfg),
                                        vocab_rows(opt1.first, cfg)).items()
              if k not in noise}
        pe, worst_step = adam_err(torch, vocab_rows(p3, cfg),
                                  vocab_rows(params1, cfg), noise,
                                  tol=TM_EXACT[dt]["params"] or 1e-5)
        out.update(tp1_losses=l1, tp1_grad_norms=n1,
                   loss_rel=[abs(x - y) / abs(y) for x, y in zip(losses, l1)],
                   grad_norm_rel=[abs(x - y) / abs(y)
                                  for x, y in zip(gnorms, n1)],
                   grad_err_max=max(ge.values()),
                   grad_err_worst=max(ge, key=ge.get),
                   grad_err_top=sorted(ge.items(), key=lambda kv: -kv[1])[:6],
                   param_share_past=max(pe.values()),
                   param_share_worst=max(pe, key=pe.get), leaves=len(ge),
                   zero_grad_leaves=grid_noise,
                   param_max_diff_over_lr=worst_step / a["lr"])
        del params1, state1, opt1, g1, p3
    ring.gather_object(None)            # every rank waits for the twin
    return out


def tm_twin_failures(a, spec):
    """(19a)'s gates on one dtype's record: the failures, as text."""
    tol, steps = TM_EXACT[a["dtype"]], spec["a"]["steps"]
    share = tol["params"] or 1e-5
    what = f"(19a) {a['dtype']}"
    bad = [k for k, v in a["replicas_bit_equal"].items() if not v]
    out = [f"{what}: replicated leaves apart: {bad}"] if bad else []
    # the global norm is AdamW's clip; its m / sqrt(v) hides a constant
    # scale on the gradients, so a replicated leaf counted twice shows
    # here and barely in the parameters
    if max(a["loss_rel"]) > 1e-5 or max(a["grad_norm_rel"]) > 1e-5 or \
            a["grad_err_max"] > tol["grads"] or \
            (tol["params"] and a["param_share_past"] > 1e-3) or \
            a["param_max_diff_over_lr"] > 2 * steps or \
            any(v >= 1e-6 for v in a["zero_grad_leaves"].values()):
        out.append(
            f"{what}: the grid against tp=1: losses {a['grid_losses']} vs "
            f"{a['tp1_losses']}, grad norms {a['grid_grad_norms']} vs "
            f"{a['tp1_grad_norms']}, step 1's gradients "
            f"{a['grad_err_top']} x max (gate {tol['grads']}), parameters "
            f"after step {steps}: {a['param_share_past']} of "
            f"{a['param_share_worst']} past {share} x max, at most "
            f"{a['param_max_diff_over_lr']} x lr apart")
    return out


def tm_full_rank(ring, spec):
    """(b) one rank of the grid: full-width opt-6.7b, f32 masters, bf16
    compute, remat block, for each ESL mode: the losses, the steps'
    walls, one step's traffic on each ring, rank 0's device time by
    kernel over one more step, peak memory and state bytes.  Returns
    every rank's record."""
    import statistics

    import torch
    from repro_torch.core.steps import build_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW, get_schedule
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import init_shard
    b_, dev = spec["b"], ring.device
    cfg = tm_cfg(None, spec["reduced"])
    out = {"rank": ring.rank}
    for mode, overlap in (("blocking", False), ("overlap", True)):
        plan = tm_plan(cfg, TM_SHAPE, esl_overlap=overlap, remat="block",
                       compute_dtype="bfloat16", param_dtype="float32")
        model = build_model(cfg, plan, dev)
        opt = AdamW(lr=get_schedule("cosine", b_["lr"], 1, b_["steps"]))
        t = time.perf_counter()
        params = init_shard(cfg, plan, ring.rank, 0, device=dev)
        state = opt.init(params)
        draw_s = time.perf_counter() - t
        state_bytes = sum(x.numel() * x.element_size() for x in
                          tree_leaves(params) + tree_leaves(state.m)
                          + tree_leaves(state.v))
        step, meta = build_train_step(model, opt, ring, b_["batch"])
        env = meta["env"]
        rows = (env.data.rank, env.dp_width)
        batches = tm_batches(cfg, b_["batch"], b_["seq"], b_["steps"] + 1,
                             rows)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        losses, walls, traffic = [], [], None
        for i in range(b_["steps"]):
            b = tm_on(torch, batches[i], dev)
            if i == b_["warm"]:
                for r in (env.model, env.data, env.world):
                    r.reset_counters()
            t = time.perf_counter()
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t)
            if i == b_["warm"]:
                traffic = {"model": dict(env.model.traffic),
                           "data": dict(env.data.traffic),
                           "world": dict(env.world.traffic)}
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else None
        prof = None
        last = tm_on(torch, batches[-1], dev)

        def one_step():
            nonlocal params, state
            params, state, _ = step(params, state, last)
            torch.cuda.synchronize(dev)
        if dev.type == "cuda":
            if ring.rank == 0:
                prof = device_kernels(one_step)
            else:
                one_step()
        first5 = sum(losses[:5]) / 5
        last5 = sum(losses[-5:]) / 5
        rec = {"losses": losses, "first5_mean": first5,
               "last5_mean": last5, "walls_s": walls,
               "ms_per_step": statistics.median(walls[b_["warm"]:]) * 1e3,
               "draw_s": draw_s, "state_bytes": state_bytes,
               "peak_memory_bytes": peak, "traffic_one_step": traffic}
        if prof is not None:
            busy = sum(e.self_device_time_total for e in prof) / 1e3
            nccl = sum(e.self_device_time_total for e in prof
                       if "nccl" in e.key.lower()) / 1e3
            top = sorted(prof, key=lambda e: -e.self_device_time_total)[:8]
            rec.update(device_ms_rank0=busy, nccl_ms_rank0=nccl,
                       top_kernels_rank0=[
                           {"name": e.key[:80], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top])
        out[mode] = rec
        del params, state, step, model
        if dev.type == "cuda":
            free_cuda(torch)
    return ring.gather_object(out)


def tm_elastic_rank(ring, spec):
    """(c) ``run_training`` on this rank's world: rank 0's losses, or
    "crashed" where the injected failure fired on every rank."""
    import torch
    from repro_torch.launch.ft import FailureInjector
    from repro_torch.launch.train import run_training
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = spec["c"]
    cfg = tm_cfg(TM_A["depth"], spec["reduced"])
    crash = spec.get("crash")
    kw = dict(cfg=cfg, steps=c["steps"], global_batch=c["batch"],
              seq_len=c["seq"], lr=c["lr"], mesh=ring, tp=TM_SHAPE[1],
              log_every=1000, ckpt_dir=spec.get("ckpt_dir"),
              ckpt_every=c["ckpt_every"],
              injector=FailureInjector([crash]) if crash else None)
    t = time.perf_counter()
    try:
        losses = run_training(**kw)[2]
    except RuntimeError as e:
        if not crash or "injected failure" not in str(e):
            raise
        losses = "crashed"
    return {"losses": losses, "wall_s": time.perf_counter() - t}


def run_train_mesh(torch, dev, card_name, lap=None, device="cuda",
                   reduced=False):
    """Phase 19 on a machine of 4 or more cards: (a) the twin, (b) the
    full model, (c) the elastic restart.  ``device="cpu"`` and
    ``reduced`` rehearse it on gloo ranks at reduced widths.  Returns
    the record."""
    t_phase = time.perf_counter()
    cards = smi_query("--query-gpu=index,name,power.limit",
                      "--format=csv,noheader").splitlines() \
        if device == "cuda" else []
    world = TM_SHAPE[0] * TM_SHAPE[1]
    small = dict(batch=4, seq=32)
    spec = {"reduced": reduced,
            "a": dict(TM_A, **small) if reduced else TM_A,
            "b": dict(TM_B, **small, steps=8) if reduced else TM_B,
            "c": dict(TM_C, **small) if reduced else TM_C}
    rec = {"card": card_name, "shape": list(TM_SHAPE), "cards_listed": cards,
           "model": TM_NAME, "a_spec": spec["a"], "b_spec": spec["b"],
           "c_spec": spec["c"], "reckoned_b": TM_RECKONED}

    fails = rec["failures"] = []

    def part(name, fn):
        """Run one part; a failure or an error is recorded and the next
        part still runs (the phase fails at its end)."""
        try:
            fails.extend(fn())
        except Exception as e:      # recorded, and the phase fails
            fails.append(f"{name}: {type(e).__name__}: "
                         f"{str(e)[-2000:]}")
        if lap is not None:
            lap(name)

    def twin():
        rec["a"] = {}
        out = []
        for dt in ("float32", "float64"):
            t0 = time.perf_counter()
            a = tm_run(tm_twin_rank, world, dict(spec, dtype=dt), device)
            a["wall_s"] = time.perf_counter() - t0
            rec["a"][dt] = a
            out += tm_twin_failures(a, spec)
        return out

    part("(19a) the twin", twin)
    part("(19b) the full model",
         lambda: tm_full(rec, spec, world, device, reduced))
    part("(19c) the elastic restart",
         lambda: tm_elastic(rec, spec, world, device))
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def tm_run(fn, n, spec, device, timeout_s=1200):
    """``run_ranks`` of phase 19: a card per rank over NCCL, or gloo
    ranks on the CPU with one torch thread each."""
    from repro_torch.core.dist import run_ranks
    if device == "cuda":
        return run_ranks(fn, n, spec, device=device,
                         placement="card_per_rank", timeout_s=timeout_s)
    return run_ranks(fn, n, spec, device=device, threads=1,
                     timeout_s=timeout_s)


def tm_full(rec, spec, world, device, reduced):
    """(b) on the grid: the ranks' records folded into ``rec``; returns
    the failures."""
    t0 = time.perf_counter()
    per_rank = tm_run(tm_full_rank, world, spec, device, timeout_s=1800)
    rec["b_s"] = time.perf_counter() - t0
    b_ = spec["b"]
    tokens = b_["batch"] * b_["seq"]
    n_params = tm_cfg(None, reduced).total_params()
    peak_ops = PEAK_OPS["bfloat16"] * world
    fails = []
    for mode in ("blocking", "overlap"):
        r0 = per_rank[0][mode]
        if any(per_rank[i][mode]["losses"] != r0["losses"]
               for i in range(world)):
            fails.append(f"(19b) {mode}: the ranks' losses differ")
        if not all(math.isfinite(x) for x in r0["losses"]) or \
                not r0["last5_mean"] < r0["first5_mean"]:
            fails.append(f"(19b) {mode}: the loss did not fall: "
                         f"{r0['losses']}")
        ms = r0["ms_per_step"]
        one = {k: v for k, v in r0.items()}
        one.update(
            ms_per_step_per_rank=[per_rank[i][mode]["ms_per_step"]
                                  for i in range(world)],
            tokens_per_s=tokens / ms * 1e3,
            flops_per_step_6nt=6 * n_params * tokens,
            mfu_bf16=6 * n_params * tokens / (ms / 1e3) / peak_ops,
            peak_memory_bytes_per_rank=[
                per_rank[i][mode]["peak_memory_bytes"]
                for i in range(world)],
            state_bytes_per_rank=[per_rank[i][mode]["state_bytes"]
                                  for i in range(world)],
            traffic_one_step_per_rank=[
                per_rank[i][mode]["traffic_one_step"] for i in range(world)])
        rec[f"b_{mode}"] = one
    rec["params"] = n_params
    return fails


def tm_elastic(rec, spec, world, device):
    """(c): the uninterrupted run, the crashed one, the resume on data 1
    x model tp; folded into ``rec``; returns the failures."""
    import shutil
    import tempfile
    # the checkpoint (~12.2 GB) goes where the disk has the most room
    roots = [tempfile.gettempdir(), os.path.join(HERE, "build")]
    os.makedirs(roots[1], exist_ok=True)
    root = max(roots, key=lambda r: shutil.disk_usage(r).free)
    base = tempfile.mkdtemp(prefix="train_mesh_", dir=root)
    free = shutil.disk_usage(base).free
    if device == "cuda" and free < 20e9:
        return [f"(19c) the checkpoint (~12.2 GB) needs room: "
                f"{free / 1e9:.1f} GB free under {base}"]
    try:
        t0 = time.perf_counter()
        full = tm_run(tm_elastic_rank, world, spec, device)
        crash = tm_run(tm_elastic_rank, world,
                       dict(spec, crash=spec["c"]["crash"],
                            ckpt_dir=os.path.join(base, "ckpt")), device)
        if crash["losses"] != "crashed":
            return ["(19c) the injector did not fire"]
        ck = os.path.join(base, "ckpt")
        steps = sorted(os.listdir(ck))
        du = shutil.disk_usage(base)
        ck_bytes = sum(os.path.getsize(os.path.join(dp, f))
                       for dp, _, fs in os.walk(ck) for f in fs)
        tp_only = tm_run(tm_elastic_rank, TM_SHAPE[1],
                         dict(spec, ckpt_dir=ck), device)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    tail = full["losses"][-len(tp_only["losses"]):]
    rel = max(abs(x - y) / abs(y) for x, y in zip(tp_only["losses"], tail))
    rec["c"] = {"uninterrupted": full["losses"], "checkpoints": steps,
                "checkpoint_bytes": ck_bytes, "disk_free_bytes": du.free,
                "checkpoint_root": root,
                "resumed_on": [1, TM_SHAPE[1]],
                "resumed": tp_only["losses"], "max_rel_diff": rel,
                "walls_s": [full["wall_s"], crash["wall_s"],
                            tp_only["wall_s"]],
                "wall_s": time.perf_counter() - t0}
    if len(tp_only["losses"]) != spec["c"]["steps"] - spec["c"][
            "ckpt_every"] or not rel <= 1e-4:
        return [f"(19c) resumed on data 1 x model {TM_SHAPE[1]}: "
                f"{tp_only['losses']} against {tail}"]
    return []


def print_train_mesh(rec, smi):
    """Phase 19's lines: each part that ran, then its failures."""
    for dt, a in rec.get("a", {}).items():
        if "loss_rel" not in a:
            continue
        print(f"[train_mesh] (19a) {TM_NAME} depth {rec['a_spec']['depth']} "
              f"{dt} on data {TM_SHAPE[0]} x model {TM_SHAPE[1]} against "
              f"tp 1: losses rel {max(a['loss_rel']):.3g}, grad norms rel "
              f"{max(a['grad_norm_rel']):.3g}, step 1's gradients "
              f"{a['grad_err_max']:.3g} x max ({a['grad_err_worst']}), "
              f"parameters after step {rec['a_spec']['steps']}: at most "
              f"{a['param_share_past']:.3g} of a leaf past "
              f"{TM_EXACT[dt]['params'] or 1e-5} x max "
              f"({a['param_share_worst']}), "
              f"{a['param_max_diff_over_lr']:.3g} x lr apart at most, "
              f"replicated leaves bit-equal "
              f"{sum(a['replicas_bit_equal'].values())}/"
              f"{len(a['replicas_bit_equal'])} | {smi}")
    for mode in ("blocking", "overlap"):
        r = rec.get(f"b_{mode}")
        if r is None:
            continue
        peak = [round(x / 1e9, 2) if x else x
                for x in r["peak_memory_bytes_per_rank"]]
        state = [round(x / 1e9, 2) for x in r["state_bytes_per_rank"]]
        print(f"[train_mesh] (19b) {TM_NAME} whole, {mode}: "
              f"{r['ms_per_step']:.1f} ms/step wall, rank 0 device "
              f"{r.get('device_ms_rank0')} ms (NCCL {r.get('nccl_ms_rank0')})"
              f", {r['tokens_per_s']:.1f} tokens/s, mfu_bf16 "
              f"{r['mfu_bf16']:.4f}, loss {r['first5_mean']:.4f} -> "
              f"{r['last5_mean']:.4f}, peak {peak} GB, state {state} GB | "
              f"{smi}")
    c = rec.get("c")
    if c is not None:
        print(f"[train_mesh] (19c) crash at {rec['c_spec']['crash']}, "
              f"resumed on data 1 x model {TM_SHAPE[1]}: tail rel "
              f"{c['max_rel_diff']:.3g}, checkpoint "
              f"{c['checkpoint_bytes'] / 1e9:.2f} GB")
    print(f"[train_mesh] phase {rec['phase_s']:.1f} s")
    for f in rec["failures"]:
        print(f"[train_mesh] FAILED {f}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "NVIDIA cards (see the module docstring).")
    ap.add_argument("--only", choices=("tp_cards", "tp_families",
                                       "tp_spec_mm", "tp_fleet",
                                       "data_axis", "train_mesh"),
                    help="tp_cards / tp_families / tp_spec_mm: build the "
                         "kernels and run phase 14 / 15 / 16 alone (2 or "
                         "more cards); tp_fleet / data_axis: phase 17 / 18 "
                         "alone (4 or more cards); train_mesh: phase 19 "
                         "alone (4 or more cards; training launches no "
                         "kernel, so none is built)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def lap(phase):
        print(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")

    if args.only == "train_mesh":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if torch.cuda.device_count() < 4:
            print(f"[train_mesh] needs 4 or more cards; this machine has "
                  f"{torch.cuda.device_count()}: not run", file=sys.stderr)
            return 1
        tm = run_train_mesh(torch, dev, smi, lap)
        print_train_mesh(tm, smi)
        print(json.dumps({"train_mesh": tm}))
        if tm["failures"]:
            print(f"[train_mesh] phase 19 failed: {tm['failures']}",
                  file=sys.stderr)
            return 1
        print(f"[time] total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    t0 = time.perf_counter()
    took = build.build()
    print(f"[build] {len(took)} kernel(s) built in "
          f"{time.perf_counter() - t0:.1f} s: {took}")
    for name in build.SOURCES:
        print(f"[build] {name} ptxas: "
              + " | ".join(ln.strip() for ln in build.build_log(name)
                           .splitlines() if "registers" in ln or
                           "spill" in ln)[:600])

    # f32 matmuls in full f32 (the chain's plain version and the model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_cards = torch.cuda.device_count()
    if args.only:
        lap("build")
        need = 4 if args.only in ("tp_fleet", "data_axis") else 2
        if n_cards < need:
            print(f"[{args.only}] needs {need} or more cards; this machine "
                  f"has {n_cards}: not run", file=sys.stderr)
            return 1
        if args.only == "data_axis":
            da = run_data_axis(torch, torch.device("cuda", 0), smi, lap)
            print_data_axis(da, smi)
            k5 = da["kernel5"]
            print(json.dumps({"kernels": [{
                "name": "mamba_scan", "route": "cuda",
                "source": os.path.relpath(build.source_path("mamba_scan"),
                                          HERE),
                "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:52",
                "main_path_entry": "mamba_scan_fused",
                # jamba's mamba layers on every rank of the grid, (b)
                "launches": da["kernel5_grid_launches"],
                "launches_per_rank": {
                    key: da[key]["kernel5_launches_per_rank"]
                    for key in ("b_jamba_f32", "b_jamba_bf16")},
                "max_abs_err": k5["max_abs_err"],
                "max_abs_err_at_ranks": da["kernel5_at_rank_per_rank"],
                "ms": k5["ms"], "plain_ms": k5["plain_ms"],
                "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
                "library_ms": None,
                "shapes": {"B": k5["shape"][0], "S": k5["shape"][1],
                           "C": k5["shape"][2], "N": k5["shape"][3],
                           "dtype": "float32"}}]}))
            print(json.dumps({"data_axis": da}))
        elif args.only == "tp_fleet":
            fl = run_tp_fleet(torch, torch.device("cuda", 0), smi, lap)
            print_tp_fleet(fl, smi)
            print(json.dumps({"tp_fleet": fl}))
        elif args.only == "tp_cards":
            tp_cards = run_tp_cards(torch, torch.device("cuda", 0), smi, lap)
            print_tp_cards(tp_cards, smi)
            print(json.dumps({"tp_cards": tp_cards}))
        elif args.only == "tp_families":
            fam = run_tp_families(torch, torch.device("cuda", 0), smi, lap)
            print_tp_families(fam, smi)
            print(json.dumps({"tp_families": fam}))
        else:
            smm = run_tp_spec_mm(torch, torch.device("cuda", 0), smi, lap)
            print_tp_spec_mm(smm, smi)
            print(json.dumps({"tp_spec_mm": smm}))
        print(f"[time] total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": n_cards}}))
        return 0

    lap("build")
    floor_ms, floor_host_ms = time_floor(torch, dev)
    print(f"[kernel] timing floor (one-element add_): {floor_ms} ms device, "
          f"{floor_host_ms} ms host")
    errs = check_paged_kernel(torch, dev)
    print(f"[kernel] paged_decode_attention vs plain: {errs}")
    times = time_paged_kernel(torch, dev, smi)
    print(f"[kernel] paged_decode_attention timing: {times}")
    quant = check_time_quantized_pool(torch, dev, smi)
    print(f"[kernel] paged_decode_attention int8/fp8 pools: {quant}")
    split_errs = check_paged_split(torch, dev)
    print(f"[kernel] paged_decode_attention split edges (lengths "
          f"{list(SPLIT_LENGTHS)}, tables out of order; rows alone equal "
          f"rows in the batch; null block inert): {split_errs}")
    nan_t = check_paged_nan(torch, dev)
    print(f"[kernel] paged_decode_attention on a NaN row (f32 K/V, int8 "
          f"scale, fp8 codes; the rows that attend it all NaN, the others "
          f"bit-equal): {nan_t}")
    chunk_t = check_time_paged_chunk(torch, dev, smi)
    print(f"[kernel] paged_decode_attention at the chunk shape (C "
          f"{PCHUNK_C} queries, one table, lengths {PCHUNK_START + 1}.."
          f"{PCHUNK_START + PCHUNK_C}): {chunk_t}")
    t_v = time.perf_counter()
    verify_t = check_time_paged_verify(torch, dev, smi)
    print(f"[kernel] paged_decode_attention at the verify shape "
          f"({len(VERIFY_POS)} slots x {VERIFY_K1} queries, a table each, "
          f"positions {list(VERIFY_POS)}; f32/int8/fp8 pools; queries alone "
          f"equal their rows): {verify_t}")
    print(f"[time] verify-shape check {time.perf_counter() - t_v:.1f} s")
    dense_errs, dense_t = check_time_dense(torch, dev, smi)
    print(f"[kernel] decode_attention vs plain: {dense_errs}; timing: "
          f"{dense_t}")
    gemv_errs, gemv_calls = check_time_gemv(torch, dev, smi)
    print(f"[kernel] gemv vs plain: max abs "
          f"{max(gemv_errs.values())}; B=4 equals 4 x B=1 at every shape")
    for c in gemv_calls:
        print(f"[kernel] gemv {c}")

    lap("kernels 1-3")
    model, params, prompts = smollm(torch, dev)
    engine = run_engine(torch, dev, model, params, prompts)
    tp1 = {"smollm-135m": (prompts, engine.pop("streams"))}
    print(f"[engine] {engine['tokens']} tokens, "
          f"{engine['tokens_per_s']:.1f} tok/s, "
          f"{engine['decode_steps']} decode steps, "
          f"{engine['preempt_run']['preemptions']} preemptions in the "
          "small-pool run")
    for twin, r in (("graphs", engine),
                    ("eager twin", engine["eager_twin"])):
        pr = r["profile"] or {}
        print(f"[engine] {twin}: {r.get('graph_captures', 0)} captured "
              f"windows, {pr.get('graph_replays')} replays in the profiled "
              f"run, {r['tokens_per_s']:.1f} tok/s, wall "
              f"{pr.get('wall_ms_per_token')} ms/token, device "
              f"{pr.get('device_ms_per_token')} ms/token, busy "
              f"{pr.get('device_busy_share')}; kernel 1: profiler "
              f"{pr.get('kernel1_profiler_count')}, registry "
              f"{pr.get('kernel1_registry_launches')} + warm-ups "
              f"{pr.get('kernel1_warm_up_launches')} | {smi}")
    pp = engine["prefill_paths"]
    print(f"[engine] prefill paths in {pp['phase_s']:.1f} s: chunked "
          f"{pp['chunked']['tokens_per_s']:.1f} tok/s "
          f"({pp['chunked']['prefill_chunks']} chunks, decode_stalls "
          f"{pp['chunked']['decode_stalls']}) against monolithic "
          f"{pp['monolithic']['tokens_per_s']:.1f} (decode_stalls "
          f"{pp['monolithic']['decode_stalls']}); prefix on "
          f"{pp['prefix_on']['tokens_per_s']:.1f} tok/s (hits "
          f"{pp['prefix_on']['prefix_hits']}, tokens saved "
          f"{pp['prefix_on']['prefill_tokens_saved']}) against off "
          f"{pp['prefix_off']['tokens_per_s']:.1f}; copy-on-write blocks "
          f"{pp['cow']['cow_blocks']}; chunked preemptions "
          f"{pp['chunked_preempt']['preemptions']}; chunk row vs "
          f"monolithic {pp['chunk_row_vs_monolithic']}")
    for name in ("monolithic", "chunked"):
        g, e = pp[name], pp[name]["eager_twin"]
        print(f"[engine] (a) {name}: graphs {g['tokens_per_s']:.1f} tok/s "
              f"(admission replays {g['admission_replays']}), eager twin "
              f"{e['tokens_per_s']:.1f} tok/s, streams equal "
              f"{e['vs_graphs']['equal']}/9 | {smi}")
    print(f"[time] (a) eager twins {pp['eager_twins_s']:.1f} s (of the "
          f"prefill paths' {pp['phase_s']:.1f} s)")

    lap("engine")
    t_tt = time.perf_counter()
    ttft_smollm = run_ttft_smollm(torch, dev, model, params,
                                  pp.pop("long_prompt"))
    for name, r in ttft_smollm.items():
        print(f"[ttft] smollm-135m {name}: {r['ttft_ms']:.3f} ms (median "
              f"of {r['requests']}: {[round(x, 3) for x in r['ttft_ms_all']]}"
              f"), prefill device {r['prefill_device_ms']:.3f} ms over "
              f"{r['device_kernels']} kernels; prompt {r['prompt_len']}, "
              f"bucket {r['bucket']}, chunk {r['prefill_chunk']} | {smi}")
    print(f"[time] ttft smollm {time.perf_counter() - t_tt:.1f} s",
          flush=True)
    qpool = run_quantized_engine(torch, dev, model, params, prompts,
                                 pp.pop("chunked_streams"))
    for qname in ("int8", "fp8"):
        r = qpool[qname]
        print(f"[engine] (f) {qname} pool: stream "
              f"{r['stream']['tokens_per_s']:.1f} tok/s, gather "
              f"{r['gather']['tokens_per_s']:.1f}; streams equal: gather "
              f"{r['gather']['vs_stream']['equal']}/9, prefix on "
              f"{r['prefix_on']['vs_off']['equal']}/4, preempted "
              f"{r['preempt']['vs_uncontended']['equal']}/8 "
              f"({r['preempt']['preemptions']} preemptions); common prefix "
              f"with f32 {r['common_prefix_vs_f32']['mean']:.3f}; bytes "
              f"moved vs f16 {r['moved_vs_f16']:.4f} (expected "
              f"{r['moved_vs_f16_expected']:.4f})")
    lap("engine (f) int8/fp8 pool")
    spec = run_speculative_engine(torch, dev, model, params, prompts)
    for name, r in spec.items():
        if isinstance(r, dict):
            print(f"[engine] (g) {name}: {r['tokens_per_s']:.1f} tok/s, "
                  f"spec_rounds {r['spec_rounds']}, acceptance "
                  f"{r.get('acceptance_rate')}, accepted/window "
                  f"{r.get('accepted_per_window')}, kernel 1 launches "
                  f"{r['kernel_launches']}")
    lap("engine (g) speculation")
    fleet = run_fleet(torch, dev, model, params, prompts, smi)
    for name, r in fleet.items():
        if isinstance(r, dict) and "fleet_counters" in r:
            print(f"[fleet] (9) {name}: {r['tokens']} tokens in "
                  f"{r['wall_s']:.2f} s, {r['tokens_per_s']:.1f} tok/s over "
                  f"the fleet's wall, counters {r['fleet_counters']}, ring "
                  f"failures {r['ring_failures']}, resets checked "
                  f"{r['resets_checked']}, straggler events "
                  f"{len(r['straggler_events'])}, kernel 1 launches "
                  f"{r['kernel_launches']} | {smi}")
    print(f"[fleet] (9) reset() on a warmed ring with 4 requests in flight: "
          f"median {fleet['reset_ms']['median']:.3f} ms of "
          f"{[round(x, 3) for x in fleet['reset_ms']['all']]} | {smi}")
    print(f"[time] (9) fleet {fleet['phase_s']:.1f} s", flush=True)
    lap("fleet (9)")
    frontend = run_frontend(torch, dev, model, params, smi)
    for name, r in frontend.items():
        if isinstance(r, dict) and "ttft_ms_p50" in r:
            print(f"[frontend] (10) {name}: completed {r['completed']} "
                  f"failed {r['failed']} cancelled {r['cancelled']} "
                  f"rejected {r['rejected']}; ttft p50/p99 "
                  f"{r['ttft_ms_p50']:.3f}/{r['ttft_ms_p99']:.3f} ms from "
                  f"the admitted submit, "
                  f"{r['ttft_arrival_ms_p50']:.3f}/"
                  f"{r['ttft_arrival_ms_p99']:.3f} ms from arrival, "
                  f"ms/token p50/p99 {r['ms_per_token_p50']:.3f}/"
                  f"{r['ms_per_token_p99']:.3f}, {r['tokens_per_s']:.1f} "
                  f"tok/s over {r['wall_s']:.3f} s, "
                  f"{r['graph_captures']} captures in the run | {smi}")
    b = frontend["b_budget_on"]
    print(f"[frontend] (10) budget {b['budget_ms']} ms: {b['plans']} plans, "
          f"distinct (C, S) {b['distinct_plans']}, first "
          f"{b['first_plans']}; {b['observed_windows']} windows and "
          f"{b['observed_chunks']} chunks observed; mu_step "
          f"{b['prior_step_ms']:.3f} -> {b['mu_step_ms']:.3f} ms (within "
          f"{FRONTEND_SETTLE:.0%} of its end after "
          f"{b['windows_to_settle']} windows), mu_tok {b['mu_tok_ms']:.4f} "
          f"ms")
    print(f"[time] (10) front end {frontend['phase_s']:.1f} s", flush=True)
    lap("front end (10)")
    del model, params
    ctx, chain, chain_launches, walls = run_chain_phase(torch, dev)
    chain["chunk_prefill"] = chunk_vs_sequential(torch, dev, ctx, "stream")
    chain["chunk_prefill_gather"] = chunk_vs_sequential(torch, dev, ctx,
                                                        "gather")
    chain.update(chain_costs(torch, ctx, walls))
    for name, rec in chain["variants"].items():
        print(f"[chain] {name}: {rec['ms_per_step']:.2f} ms/step, "
              f"{rec['tokens_per_s']:.1f} tok/s, kernels vs plain "
              f"{rec['max_abs_err_vs_plain']:.3g}")

    # phase (h) holds at most ~16 GB (opt-6.7b in bf16): free what the
    # earlier phases hold first
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    lap("chain")
    opt = run_opt(torch, dev, smi, t_start)
    h1 = opt["h1_engine"]
    from repro_torch.configs import get_config
    tp1["opt-1.3b"] = (opt_prompts(get_config("opt-1.3b"))[0],
                       h1.pop("streams"))
    print(f"[opt] (h1) {h1['arch']} f32 at full width: stream "
          f"{h1['stream']['tokens_per_s']:.1f} tok/s, kernel 1 launches "
          f"{h1['launches']['paged_decode_attention']}; streams equal: "
          f"gather {h1['gather']['vs_stream']['equal']}/8, preempted "
          f"{h1['preempt']['vs_uncontended']['equal']}/8 "
          f"({h1['preempt']['preemptions']} preemptions), chunked + prefix "
          f"{h1['chunked_prefix']['vs_monolithic']['equal']}/4 "
          f"({h1['chunked_prefix']['prefix_hits']} hits, "
          f"{h1['chunked_prefix']['prefill_chunks']} chunks); distinct "
          f"tokens per stream {h1['distinct_tokens_per_stream']}")
    for name, rec in opt["h2_chain"]["variants"].items():
        print(f"[opt] (h2) chain {name}: {rec['ms_per_step']:.2f} ms/step "
              f"wall, kernels vs plain {rec['max_abs_err_vs_plain']:.3g}, "
              f"vs the model {rec['max_abs_err_vs_model']:.3g}")
    prof_h2 = opt["h2_chain"]["profile_stream"]
    if prof_h2:
        print(f"[opt] (h2) chain stream: {prof_h2['device_ms_per_step']:.3f}"
              f" device ms/step, busy {prof_h2['device_busy_share']:.3f}")
    for key, t in opt["h3_kernel1"].items():
        print(f"[opt] (h3) kernel 1 {key}: {t['ms']:.5f} ms, plain "
              f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
              f"{t['bound_ms']:.6f} ({t['bound_by']}), max abs "
              f"{t['max_abs_err']:.3g}")
    for t in opt["h3_gemv"]:
        print(f"[opt] (h3) gemv {t['shape']} {t['dtype']} B={t['B']} "
              f"bias={t['bias']}: {t['ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f}, library {t['library_ms']:.5f}, bound "
              f"{t['bound_ms']:.5f}")
    for name, r in opt["h4_protocol"].items():
        tw, pw = r["eager_twin"], r["profiled_window"]
        print(f"[opt] (h4) {name} graphs: {r['graph_captures']} captured "
              f"windows, {r['graph_replays']} replays, wall "
              f"{r['wall_ms_per_token']:.3f} ms/token, device "
              f"{r['device_ms_per_token']:.3f} ({r['device_ms_source']}; "
              f"kernel 1 in the profiled steps: profiler "
              f"{pw['kernel1_profiler_count']}, registry "
              f"{pw['kernel1_registry_launches']}); eager twin: wall "
              f"{tw['wall_ms_per_token']:.3f} ms/token, device "
              f"{tw['device_ms_per_token']:.3f}, busy "
              f"{tw['device_busy_share']:.3f}; streams equal | {smi}")
        for twin, t in (("graphs", r["ttft"]), ("eager twin", tw["ttft"])):
            print(f"[ttft] {name} bf16 {twin}: {t['ttft_ms']:.3f} ms "
                  f"(median of {t['requests']}: "
                  f"{[round(x, 3) for x in t['ttft_ms_all']]}), prefill "
                  f"device {t['prefill_device_ms']:.3f} ms over "
                  f"{t['device_kernels']} kernels; prompt "
                  f"{t['prompt_len']}, bucket {t['bucket']} | {smi}")
            print(f"[time] (h4) ttft {name} {twin} {t['phase_s']:.1f} s")
        paper = ", ".join(f"{k} {v:.4g}" for k, v in r["paper"].items()
                          if k != "source")
        print(f"[opt] (h4) {name} bf16 batch 1, in {r['in_tokens']} out "
              f"{r['out_tokens']} (asked {r['out_tokens_asked']}): wall "
              f"{r['wall_ms_per_token']:.3f} ms/token, device "
              f"{r['device_ms_per_token']:.3f} ms/token (torch.profiler, "
              f"{r['profiled_window']['decode_steps']} decode steps at "
              f"positions {r['profiled_window']['positions']}), busy "
              f"{r['device_busy_share']:.3f}, "
              f"{r['bytes_per_token'] / 1e9:.3f} GB/token (weights "
              f"{r['weight_bytes_per_token'] / 1e9:.3f} + KV at mean "
              f"length {r['mean_length']:.0f}), bandwidth use "
              f"{r['bandwidth_use_device']:.3f} by device time, "
              f"{r['bandwidth_use_wall']:.3f} by wall, of "
              f"{r['bandwidth_Bps'] / 1e12:.2f} TB/s (bound "
              f"{r['bound_ms_per_token']:.3f} ms/token) | {smi} | the "
              f"paper's figures ({r['paper']['source']}): {paper}")

    # the rwkv phase needs ~31 GB: free what the earlier phases hold
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rwkv_errs, rwkv_exact, rwkv_t = check_time_rwkv_scan(torch, dev, smi)
    print(f"[kernel] rwkv_scan vs plain: {rwkv_errs}; bit-equal: "
          f"{rwkv_exact}")
    for name, t in rwkv_t.items():
        print(f"[kernel] rwkv_scan {name} timing: {t}")
    lap("opt, kernel 4")
    rwkv = run_rwkv(torch, dev)
    print(f"[rwkv] {rwkv['tokens']} tokens, {rwkv['tokens_per_s']:.1f} "
          f"tok/s, {rwkv['device_decode_steps']} device decode steps, "
          f"{rwkv['launches_per_device_decode_step']:.0f} rwkv_scan launches "
          f"per step, decode step {rwkv['decode_step_ms_b4']:.2f} ms at "
          f"{RWKV_SLOTS} rows, replay kernel vs plain max abs "
          f"{rwkv['replay']['max_abs_err_vs_plain']:.3g}")

    # the jamba phase holds ~54 GB: free everything the rwkv phase held
    # first, so two full-width models never share the card
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    print(f"[jamba] device memory allocated before the phase: {held} bytes",
          flush=True)
    if held > 2e9:
        raise AssertionError(f"{held} bytes still allocated after the rwkv "
                             "phase")
    mamba_errs, mamba_exact, mamba_t = check_time_mamba_scan(torch, dev, smi)
    print(f"[kernel] mamba_scan (a) and mamba_scan_fused vs plain: "
          f"{mamba_errs}; bit-equal: {mamba_exact}")
    for name, t in mamba_t.items():
        print(f"[kernel] mamba_scan {name} timing: {t}")
    lap("rwkv, kernel 5")
    jamba = run_jamba(torch, dev)
    lap("jamba")
    print(f"[jamba] {jamba['tokens']} tokens, {jamba['tokens_per_s']:.1f} "
          f"tok/s, {jamba['device_decode_steps']} device decode steps + "
          f"{jamba['prefills']} prefills, "
          f"{jamba['mamba_scan_per_device_decode_step_and_prefill']} "
          f"mamba_scan_fused launches per decode step and per prefill, decode "
          f"step {jamba['decode_step_ms_b4']:.2f} ms at {JAMBA_SLOTS} rows, "
          f"peak memory {jamba['peak_memory_bytes'] / 1e9:.2f} GB, replay "
          f"kernel vs plain max abs "
          f"{jamba['replay']['max_abs_err_vs_plain']:.3g}")

    families = run_families(torch, dev, smi)
    for fam, t in families["kernel1"].items():
        sh = t["shapes"]
        print(f"[kernel] paged_decode_attention at {fam}'s shape (H "
              f"{sh['H']} over G {sh['G']}, gs {sh['gs']}, dh {sh['dh']}, "
              f"{sh['dtype']} pool): {t['ms']:.5f} ms, plain "
              f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
              f"{t['bound_ms']:.6f} ({t['bound_by']}), max abs "
              f"{t['max_abs_err']:.3g}; split edges {t['split_edges']} | "
              f"{smi}")
    for key in ("granite", "llama4", "llava"):
        m = families[key]
        e, ds = m["engine"], m["engine"]["decode_step"]
        print(f"[families] ({key}) {m['arch']} {m['dtype']} {m['n_layers']}"
              f"/{m['n_layers_published']} layers: {e['tokens']} tokens, "
              f"{e['tokens_per_s']:.1f} tok/s on graphs (captures "
              f"{ {k: round(v, 2) for k, v in e['capture_s'].items()} } s), "
              f"eager twin {e['eager_twin']['tokens_per_s']:.1f} tok/s, "
              f"streams equal {e['eager_twin']['vs_graphs']['equal']}/"
              f"{e['requests']}; decode step on graphs "
              f"{ds['device_ms_per_step']:.3f} ms, "
              f"{ds['kernels_per_step']:.0f} kernels, kernel 1 "
              f"{ds['kernel1_ms_per_step']:.4f} ms; kernel 1 launches "
              f"{e['kernel_launches']} | {smi}")
        print(f"[families] ({key}) decode on graphs: "
              f"{e['decode_stretch']['wall_ms_per_step']:.3f} ms/step wall "
              f"at {e['decode_stretch']['rows']} rows, busy "
              f"{e['decode_stretch']['device_busy_share']:.3f}")
        if "expert_loop" in m:
            x = m["expert_loop"]
            print(f"[families] ({key}) expert loop at {x['rows']} rows: "
                  f"{x['device_ms']:.3f} device ms over {x['kernels']} "
                  f"kernels in {x['moe_layers']} MoE layers")
    st = families["llava"]["steps"]
    print(f"[families] (c) llava steps: {st['patches']} patches + "
          f"{st['text_tokens']} text tokens, prefill device "
          f"{st['prefill_device_ms']:.3f} ms over {st['prefill_kernels']} "
          f"kernels, serve {st['serve_wall_ms_per_step']:.3f} ms/step wall, "
          f"equal to the recompute twin {st['equal_to_recompute']}/"
          f"{len(st['tokens'])} | {smi}")
    w = families["whisper"]
    print(f"[families] (d) whisper-tiny: {w['rows']} rows x "
          f"{w['serve_steps']} serve steps, {w['serve_wall_ms_per_step']:.3f}"
          f" ms/step wall, {w['serve_device_busy_ms_per_step']:.3f} device "
          f"busy over {w['serve_kernels_per_step']} kernels, equal to the "
          f"recompute twin {w['equal_to_recompute']}/{w['checked']} | "
          f"{smi}")
    print(f"[time] (11) families {families['phase_s']:.1f} s", flush=True)
    lap("families (11)")
    tp1["whisper-tiny"] = w["tokens"]

    train = run_training_phase(torch, dev, smi)
    ta, tb, c = train["a"], train["b"], train["c"]
    print(f"[train] (a) smollm-135m 30 steps: loss {ta['first5_mean']:.4f} "
          f"-> {ta['last5_mean']:.4f} (means of 5); (b) resumed at step "
          f"{tb['resumed_at_step']}, max rel diff "
          f"{tb['max_rel_diff_vs_a']:.3g}; (c) accum 1 vs {TRAIN_ACCUM} "
          f"{c['accum_losses']}; "
          f"{c['ms_per_step']:.1f} ms/step wall, {c['step_device_ms']} "
          f"device over {c['step_kernels']} kernels, "
          f"{c['tokens_per_s']:.0f} tokens/s, peak "
          f"{c['peak_memory_bytes'] / 1e9:.2f} GB, optimizer "
          f"{c['optimizer_device_ms']:.3f} ms, save "
          f"{c['checkpoint_save_s']:.2f} s, mfu_f32 {c['mfu_f32']:.3f}; (d) "
          f"launches {train['d']['launches']} | {smi}")
    print(f"[time] (12) training {train['phase_s']:.1f} s", flush=True)
    lap("training (12)")

    tp = run_tp(torch, dev, smi, tp1)
    for name, m in tp["models"].items():
        for k, r in m["runs"].items():
            print(f"[tp] (13) {name} tp {TP} {k}: {r['tokens']} tokens in "
                  f"{r['wall_s']:.2f} s ({r['tokens_per_s']:.1f} tok/s), "
                  f"{r['device_decode_steps']} decode steps, kernel 1 "
                  f"launches per rank {r['kernel1_launches_per_rank']} "
                  f"(want {r['kernel1_want']}), "
                  f"{r['collectives_per_decode_step']:.1f} collectives and "
                  f"{r['hops_per_decode_step']:.1f} hops and "
                  f"{r['staged_bytes_per_decode_step']:.0f} host-staged "
                  f"bytes per decode step, {r['ring_s']:.2f} s inside the "
                  f"collectives, equal to tp=1 "
                  f"{r['vs_tp1']['equal']}/{len(tp1[name][1])} | {smi}")
        for k, r in m["runs"].items():
            if "spec_rounds" in r:
                print(f"[tp] (13e) {name} tp {TP} {k}: {r['spec_rounds']} "
                      f"verify rounds, acceptance "
                      f"{r['acceptance_rate']:.3f} "
                      f"({r['accepted_tokens']}/{r['draft_tokens']}), "
                      f"{r['accepted_per_window']:.2f} accepted a round, "
                      f"the same {r['proposals']} proposals on every rank "
                      f"(crc32 {r['proposals_crc32']})")
        print(f"[tp] (13) {name}: kernel 1 at the ranks' shapes "
              f"{m['kernel1_shapes']} max abs "
              f"{m['kernel1_max_abs_err_per_rank']}, pad heads per rank "
              f"{m['pad_heads_per_rank']}, setup {m['setup_s']} s")
    tj = tp["jamba"]
    print(f"[tp] (13c) jamba-v0.1-52b {tj['n_layers']} layers f32 tp {TP} "
          f"overlap: {tj['tokens']} tokens in {tj['wall_s']:.2f} s, "
          f"{tj['device_decode_steps']} decode steps + {tj['prefills']} "
          f"prefills, kernel 5 launches per rank "
          f"{tj['kernel5_launches_per_rank']} (want {tj['kernel_want']}), "
          f"kernel 5 at the rank's shapes {tj['kernel5_at_rank_per_rank']}, "
          f"equal to tp=1 {tj['vs_tp1']['equal']}/{tj['vs_tp1']['of']}, "
          f"peak memory per rank "
          f"{tj['peak_memory_bytes_per_rank']} | {smi}")
    d = tj["whole_shard_draw"]
    print(f"[tp] (13d) jamba-v0.1-52b whole, rank 0's shard at tp {TP} in "
          f"bf16 drawn alone: {d['shard_bytes'] / 1e9:.2f} GB in "
          f"{d['draw_s']:.1f} s, peak {d['peak_bytes'] / 1e9:.2f} GB "
          f"({d['peak_over_shard_bytes'] / 1e9:.2f} over the shard; a tp=1 "
          f"MoE layer {d['moe_layer_tp1_bytes'] / 1e9:.2f}) | {smi}")
    tw = tp["whisper"]
    print(f"[tp] (13e) whisper-tiny f32 tp {TP} overlap, {tw['rows']} rows x "
          f"{tw['serve_steps']} serve steps through the ring's steps: equal "
          f"to phase 11 (d) {tw['equal']}/{tw['of']}, serve "
          f"{tw['serve_wall_ms_per_step']:.2f} ms/step wall, prefill "
          f"{tw['prefill_s']:.2f} s, {tw['collectives']} collectives, ranks "
          f"{tw['rank_s']} s | {smi}")
    print(f"[time] (13) tp {tp['phase_s']:.1f} s (ranks "
          f"{tp['ranks_s']:.1f} s, jamba's tp=1 reference "
          f"{tj['tp1_s']:.1f} s with (13d))", flush=True)
    lap("tp (13)")

    tp_cards = None
    if n_cards >= 2:
        tp_cards = run_tp_cards(torch, torch.device("cuda", 0), smi, lap)
        print_tp_cards(tp_cards, smi)
        lap("tp_cards (14)")
        tp_families = run_tp_families(torch, torch.device("cuda", 0), smi,
                                      lap)
        print_tp_families(tp_families, smi)
        lap("tp_families (15)")
        tp_spec_mm = run_tp_spec_mm(torch, torch.device("cuda", 0), smi,
                                    lap)
        print_tp_spec_mm(tp_spec_mm, smi)
        lap("tp_spec_mm (16)")
    else:
        tp_families = tp_spec_mm = None
        print(f"[tp_cards] (14), [tp_families] (15) and [tp_spec_mm] (16) "
              f"need 2 or more cards; this machine has {n_cards}: not run")
    tp_fleet = None
    if n_cards >= 4:
        tp_fleet = run_tp_fleet(torch, torch.device("cuda", 0), smi, lap)
        print_tp_fleet(tp_fleet, smi)
        lap("tp_fleet (17)")
    else:
        print(f"[tp_fleet] (17) needs 4 or more cards; this machine has "
              f"{n_cards}: not run")

    def src(name):
        return os.path.relpath(build.source_path(name), HERE)

    f32_calls = [c for c in gemv_calls if c["w_dtype"] == "float32"]
    L_ = engine["n_layers"]
    opt_k1 = {"opt_engine": opt["h1_engine"]["launches"][
                  "paged_decode_attention"],
              "opt_chain": opt["h2_chain"]["launches"][
                  "paged_decode_attention"],
              "opt_paper_protocol": sum(
                  r["launches"]["paged_decode_attention"]
                  for r in opt["h4_protocol"].values())}
    # phase 13: every run's launches on every rank
    tp_k1 = {f"tp{TP}_{name}_{k}": sum(r["kernel1_launches_per_rank"])
             for name, m in tp["models"].items()
             for k, r in m["runs"].items()}
    tp_k5 = {f"tp{TP}_jamba_overlap": sum(
        tp["jamba"]["kernel5_launches_per_rank"])}
    fam_k4 = {}
    if tp_families is not None:
        # phase 15: (a)'s requests and batches, (b) on every rank; (c)
        fa = tp_families["a"]["runs"]
        tp_k5.update({f"tp_families_a_{k}": sum(r[
            "kernel5_launches_per_rank"]) + sum(r["batch4"][
                "kernel5_launches_per_rank"]) for k, r in fa.items()},
            tp_families_b=sum(tp_families["b"]["kernel_launches_per_rank"]))
        fam_k4["tp_families_c"] = sum(
            tp_families["c"]["kernel_launches_per_rank"])
        tp_k1["tp_families_d_granite"] = sum(
            tp_families["d"]["kernel_launches_per_rank"])
        # phase 16: (a)'s protocols and batches, (b) and (c) on every rank
        for k, r in tp_spec_mm["a"]["runs"].items():
            tp_k1[f"tp_spec_mm_a_{k}"] = sum(
                r["plain"]["kernel1_launches_per_rank"]
                + r["spec"]["kernel1_launches_per_rank"]
                + r["batch4_spec"]["kernel1_launches_per_rank"])
        tp_k1["tp_spec_mm_b"] = sum(
            tp_spec_mm["b"]["kernel1_launches_per_rank"])
        tp_k1["tp_spec_mm_c"] = sum(
            sum(r["kernel1_launches_per_rank"])
            for r in tp_spec_mm["c"].values())
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": src("paged_decode_attention"),
        "replaces": "src/repro/kernels/decode_attention/"
                    "decode_attention.py:142",
        "ok": True,
        "launches": engine["kernel_launches"] + pp["kernel_launches"]
        + qpool["kernel_launches"] + spec["kernel_launches"]
        + chain_launches["paged_decode_attention"] + sum(opt_k1.values())
        + fleet["kernel_launches"] + frontend["kernel_launches"]
        + families["kernel_launches"] + sum(tp_k1.values()),
        "launches_by_path": {
            "engine_stream": engine["kernel_launches"],
            "engine_int8_fp8_pool": qpool["kernel_launches"],
            "engine_speculative": spec["kernel_launches"],
            "engine_chunked": pp["chunked"]["kernel_launches"],
            "engine_prefix": pp["prefix_on"]["kernel_launches"],
            "engine_cow": pp["cow"]["kernel_launches"],
            "engine_chunked_preempt":
                pp["chunked_preempt"]["kernel_launches"],
            "chain_kernel_runs": chain_launches["paged_decode_attention"],
            "fleet": fleet["kernel_launches"],
            "frontend": frontend["kernel_launches"],
            **{f"{k}_engine": families[k]["engine"]["kernel_launches"]
               for k in ("granite", "llama4", "llava")},
            **opt_k1, **tp_k1},
        "max_abs_err": errs["q=float32,pool=float32"],
        "max_abs_err_by_dtype": errs,
        "max_abs_err_split_edges": split_errs,
        "nan_row": nan_t,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
        "host_ms": times["host_ms"], "plain_host_ms": times["plain_host_ms"],
        "library_host_ms": times["library_host_ms"],
        "shapes": {"B": B, "H": H, "G": G, "dh": DH, "bs": BS, "T": T,
                   "N": N, "lengths": list(LENGTHS), "dtype": "float32",
                   "fold": True},
        "plan": times["plan"],
        "quantized_pools": quant,
        # as the chunked prefill and the prefix tails call it
        "chunk": dict(chunk_t, launches=sum(
            pp[k]["kernel_launches"] - L_ * pp[k]["device_decode_steps"]
            for k in ("chunked", "prefix_on", "cow", "chunked_preempt"))),
        # as speculative verify calls it: every slot's K + 1 queries
        "verify": dict(verify_t["float32"], by_pool=verify_t,
                       launches=L_ * spec["verify_rounds"]),
        # at the paper's protocol shape (B 1, H = G = 32, length 1040,
        # bf16), as OPT's decode calls it
        "opt_shapes": opt["h3_kernel1"],
        # at the GQA shapes of granite (gs 3, dh 64, f32), llama4 (gs 5,
        # dh 128, bf16) and llava (gs 7, dh 128, bf16), as their decode
        # calls it
        "family_shapes": families["kernel1"],
        # at each rank's heads on the tp 2 ring (phase 13), f32 pool
        "tp_rank_shapes": {
            name: {"shapes": m["kernel1_shapes"],
                   "max_abs_err_per_rank": m["kernel1_max_abs_err_per_rank"]}
            for name, m in tp["models"].items()},
        # at the heads of the ranks of phase 14 (2 or more cards only)
        "tp_cards_shapes": tp_cards and tp_cards["d_kernel1"],
        # at llava's rank heads at tp 2, decode and verify shapes (phase
        # 16, 2 or more cards only)
        "tp_spec_mm_shapes": tp_spec_mm and tp_spec_mm["e_kernel1"],
    }, {
        "name": "decode_attention", "route": "cuda",
        "source": src("decode_attention"),
        "replaces": "src/repro/kernels/decode_attention/"
                    "decode_attention.py:218",
        "ok": True, "launches": chain_launches["decode_attention"]
        + opt["h2_chain"]["launches"]["decode_attention"],
        "launches_by_path": {
            "chain_kernel_runs": chain_launches["decode_attention"],
            "opt_chain": opt["h2_chain"]["launches"]["decode_attention"]},
        "max_abs_err": dense_errs["float32"],
        "max_abs_err_by_dtype": dense_errs,
        "ms": dense_t["ms"], "plain_ms": dense_t["plain_ms"],
        "bound_ms": dense_t["bound_ms"], "bound_by": dense_t["bound_by"],
        "library_ms": dense_t["library_ms"],
        "host_ms": dense_t["host_ms"],
        "plain_host_ms": dense_t["plain_host_ms"],
        "library_host_ms": dense_t["library_host_ms"],
        "shapes": {"B": B, "H": H, "G": G, "dh": DH, "S": DENSE_S,
                   "lengths": list(DENSE_LENGTHS), "dtype": "float32"},
        "plan": dense_t["plan"],
    }, {
        "name": "gemv", "route": "cuda", "source": src("gemv"),
        "replaces": "src/repro/kernels/gemv/gemv.py:55",
        "ok": True, "launches": chain_launches["gemv"]
        + opt["h2_chain"]["launches"]["gemv"],
        "launches_by_path": {"chain_kernel_runs": chain_launches["gemv"],
                             "opt_chain": opt["h2_chain"]["launches"]["gemv"]},
        "max_abs_err": max(v for k, v in gemv_errs.items()
                           if ",float32," in k),
        "max_abs_err_by_case": gemv_errs,
        # the four gemvs of one decoder layer (f32, B = 4), summed
        "ms": sum(c["ms"] for c in f32_calls),
        "plain_ms": sum(c["plain_ms"] for c in f32_calls),
        "bound_ms": sum(c["bound_ms"] for c in f32_calls),
        "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                   for c in f32_calls) else "operations",
        "library_ms": sum(c["library_ms"] for c in f32_calls),
        "unit": "sum of the 4 gemvs of one layer, float32, B=4",
        "per_call": gemv_calls,
        # opt-1.3b's four gemvs with their bias, 1 and 4 rows, f32, bf16
        "opt_shapes": opt["h3_gemv"],
    }, {
        "name": "rwkv_scan", "route": "cuda", "source": src("rwkv_scan"),
        "replaces": "src/repro/kernels/rwkv_scan/rwkv_scan.py:50",
        "ok": True, "launches": rwkv["launches"]["rwkv_scan"]
        + sum(fam_k4.values()),
        "launches_by_path": {"rwkv_engine": rwkv["launches"]["rwkv_scan"],
                             "rwkv_replay_kernel":
                                 rwkv["replay"]["decode_launches_kernel"],
                             **fam_k4},
        "max_abs_err": max(rwkv_errs.values()),
        "max_abs_err_by_shape": rwkv_errs,
        "bit_equal_by_shape": rwkv_exact,
        # at the engine's decode shape; no PyTorch call computes the
        # recurrence, so library_ms is null
        "ms": rwkv_t["decode"]["ms"], "plain_ms": rwkv_t["decode"]["plain_ms"],
        "bound_ms": rwkv_t["decode"]["bound_ms"],
        "bound_by": rwkv_t["decode"]["bound_by"], "library_ms": None,
        "host_ms": rwkv_t["decode"]["host_ms"],
        "plain_host_ms": rwkv_t["decode"]["plain_host_ms"],
        "shapes": {"B": RWKV_DECODE[0], "S": RWKV_DECODE[1],
                   "H": RWKV_DECODE[2], "dh": RWKV_DECODE[3],
                   "dtype": "float32"},
        "prefill": dict(rwkv_t["prefill"],
                        comparator="chunked_ms: the port's wkv_chunked "
                                   "(plain PyTorch), time_mix_fwd's "
                                   "prefill path"),
        # at the ranks' heads (phase 15, 2 or more cards)
        "tp_families_shapes": tp_families and {
            k: v for k, v in tp_families["e_scans"].items()
            if k.startswith("rwkv")},
    }, {
        "name": "mamba_scan", "route": "cuda", "source": src("mamba_scan"),
        "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:52",
        # the jamba engine runs entry (b), mamba_scan_fused, only
        "ok": True, "launches": jamba["launches"]["mamba_scan_fused"]
        + sum(tp_k5.values()),
        "main_path_entry": "mamba_scan_fused",
        "launches_by_path": {
            "jamba_engine": jamba["launches"]["mamba_scan_fused"],
            "jamba_replay_kernel":
                jamba["replay"]["prefill_launches_kernel"]
                + jamba["replay"]["decode_launches_kernel"],
            **tp_k5},
        # at each rank's channels on the tp 2 ring (phase 13), and
        # (2 or more cards) phase 15's
        "tp_rank_shapes": {
            "shape": tp["jamba"]["kernel5_shape"],
            "per_rank": tp["jamba"]["kernel5_at_rank_per_rank"]},
        "tp_families_shapes": tp_families and {
            k: v for k, v in tp_families["e_scans"].items()
            if k.startswith("mamba")},
        "max_abs_err": max(max(e.values()) for e in mamba_errs.values()),
        "max_abs_err_by_entry_and_shape": mamba_errs,
        "bit_equal_by_entry_and_shape": mamba_exact,
        # at the engine's decode shape: ms, plain_ms and bound_ms are
        # entry (a)'s, fused_* entry (b)'s, old_path_ms the producers of
        # da and bx + entry (a); no PyTorch call computes the recurrence,
        # so library_ms is null
        "ms": mamba_t["decode"]["ms"],
        "plain_ms": mamba_t["decode"]["plain_ms"],
        "bound_ms": mamba_t["decode"]["bound_ms"],
        "bound_by": mamba_t["decode"]["bound_by"], "library_ms": None,
        "host_ms": mamba_t["decode"]["host_ms"],
        "plain_host_ms": mamba_t["decode"]["plain_host_ms"],
        "fused_ms": mamba_t["decode"]["fused_ms"],
        "fused_plain_ms": mamba_t["decode"]["fused_plain_ms"],
        "fused_bound_ms": mamba_t["decode"]["fused_bound_ms"],
        "fused_bound_by": mamba_t["decode"]["fused_bound_by"],
        "old_path_ms": mamba_t["decode"]["old_path_ms"],
        "shapes": {"B": MAMBA_DECODE[0], "S": MAMBA_DECODE[1],
                   "C": MAMBA_DECODE[2], "N": MAMBA_DECODE[3],
                   "dtype": "float32"},
        "decode": mamba_t["decode"],
        "prefill64": mamba_t["prefill64"],
        "prefill512": mamba_t["prefill512"],
    }]
    print(json.dumps({"kernels": kernels, "floor_ms": floor_ms,
                      "floor_host_ms": floor_host_ms}))
    print(json.dumps({"engine": dict(engine, quantized_pool=qpool,
                                     speculation=spec)}))
    print(json.dumps({"chain": chain}))
    print(json.dumps({"rwkv": rwkv}))
    print(json.dumps({"jamba": jamba}))
    print(json.dumps({"opt": opt}))
    print(json.dumps({"ttft": {
        "smollm-135m": ttft_smollm,
        **{name: {"graphs": r["ttft"], "eager_twin": r["eager_twin"]["ttft"]}
           for name, r in opt["h4_protocol"].items()},
        "card": smi}}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"frontend": frontend}))
    print(json.dumps({"families": families}))
    print(json.dumps({"train": train}))
    print(json.dumps({"tp": tp}))
    if tp_cards is not None:
        print(json.dumps({"tp_cards": tp_cards}))
        print(json.dumps({"tp_families": tp_families}))
        print(json.dumps({"tp_spec_mm": tp_spec_mm}))
    if tp_fleet is not None:
        print(json.dumps({"tp_fleet": tp_fleet}))
    print(f"[time] total {time.perf_counter() - t_start:.1f} s (limit "
          "1200 s)")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
