"""Drive the PyTorch + CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --fold   # phases 1-2, 5, 8 and the folds alone

It runs in three processes on the one card.  After phases 1-2 this
process starts ``chip_smoke.py --lm-half DIR``, the LM half's run: phase
3's model-kernel cases, then phases 18-20 and 22-26, side by side with
the trace half (phase 3's trace-kernel cases and phases 4-16, host-bound)
here; it saves the inputs of the LM timing rows to ``DIR`` and exits.
``chip_smoke.py --lm-timing DIR`` starts with it and waits.  When both
the trace half and the LM run are done, this process saves the trace
kernels' main-path inputs to ``DIR`` and waits while the timing process
runs every timing row: phase 17's (the trace kernels) and those that time
an LM kernel (phase 21, the train step's profile and the backward
kernel's row, phase 26's profiled MoE step and the router backward's
rows), so no timing shares the card.  Every profiler session of
the run is in that process, which did nothing else: in a process that
had profiled before a long wait, sessions recorded only part of the
kernels, and this process's phase 17 once saw no device time three
profiles in a row after the trace half's work.  The children's lines
come through behind the tags ``[lm]`` and ``[lm timing]``.  A failure
in any process fails the run (the trace half checks the children
between its phases); the last line is printed only after all passed.
Each half logs its peak device memory (their sum must fit the card) and
the run logs each half's wall and how much of the LM half's work the
trace half hid.

Phases (any failure raises and exits non-zero):

1. device  — name, count and ``nvidia-smi`` name / power limit;
2. build   — compile every ``src/repro_torch/csrc/*.cu`` for sm_90a and
             print the ptxas register / shared-memory / spill lines;
3. kernels — each kernel against its plain PyTorch version on the card at
             its path's shapes, wider shapes and edge cases, and
             bit-identical on relaunch (the trace kernels; ``seg_sum``,
             ``pair_sum`` and ``time_bin`` through the path the wrapper
             picks and, up to 6,144 cells, also through the sorted one:
             ignored records, runs, K = 1, 3, 8 and 11, the threshold's
             two sides, large grids, NaN and infinite coordinates for
             ``time_bin``; flash attention in bf16
             and f32 with causal, window + prefix, non-causal, GQA,
             padded-tail and one-query cases, gemma3-27b's local layers
             (H 32 over KVH 16, D = 128, window 1,024) and hymba-1.5b's
             (H 25 over KVH 5, D = 64, window 1,024 + 128 prefix keys,
             rows whose window edge falls past the prefix),
             whisper-medium's encoder ([4, 1,500, 16, 64] non-causal: a
             padded tail and no other mask) and cross-attention (4 x 448
             and 4 x 1 query rows over 1,500 frames, Sq != Sk) and
             phi-3-vision's prefill ([4, 1,168, 32, 96] causal: D = 96,
             the tensor-core kernel in bf16, SIMT in f32), these four and
             the two
             GQA groupings of phase 25 in bf16 on
             peaked draws (q x 4, v uniform on [-3.5, 3.5]: outputs of
             order one, each gate at most a tenth of its case's mean
             |output|), each bf16
             case at D = 64, 96 or 128 through both kernel variants, the
             tensor-core one the wrapper picks and the SIMT one; its
             backward kernel in bf16
             and f32 at the training shape, GQA, window + prefix (with an
             offset), a padded tail and phi-3-vision's prefill shape, D =
             64, 96 and 128, on the forward kernel's output and row
             log-sum-exp, each bf16 case at D = 64, 96 or 128 through
             both backward variants (tensor-core, picked, and SIMT);
             ``hist_bin`` through its narrow path (up to 32 bins) and its
             wide one, counts exact, on
             +inf, 3e9, -0.0, NaN and -inf coordinates, N = 1, N not a
             multiple of 4 and coordinates off the 16-byte boundary; top-k
             through its narrow path (E up to 128) and its wide one, each
             exact against the plain version and the two bit for bit, at
             the serving shape, E = 5, 33, 64, 127, 128, 129 and 300, k = 1
             to 8, ragged T, exact ties and rows of -inf or at or below
             -1e30 (a row holding NaN is logged only); the fused router
             at the serving model's prefill and decode shapes, E = 128
             with k = 8, a ragged depth with odd E, all-zero rows, and a
             depth split over a cluster at odd E);
4. reader  — a small ``big_trace`` jsonl trace through ``Trace.open`` and
             the six ops on the card and on the CPU;
5. main    — the trace path: 10M events over 64 ranks (``big_trace``
             parameters, seed 0): structure, then the seven op calls of
             the six ops (``stragglers`` at a threshold of -1, every
             rank) on the card, each held against the CPU path; the trace
             kernels' launch counts (and those of ``seg_sum``, ``pair_sum``
             and ``time_bin`` by path) are reset just before and read just
             after: each must have risen, every call of the three must
             have taken the private path and ``hist_bin``'s its narrow
             path;
6. query   — lazy plans over the same in-memory trace on the card:
             ``trace.query().filter(Name not-in [MpiSend])
             .restrict_processes(range(32))`` (structure remapped) and
             each op, then ``filter(Name not-in [halo_exchange()])``
             (structure recomputed) and the two message ops; each result
             the bits of the same selection made eagerly and reduced on
             the card; ``stragglers`` on the whole trace and the first
             plan within the gate of the CPU path; counts reset before the
             plans and read after them, as in phase 5;
7. stream  — ``Trace.open(paths, streaming=True, chunk_rows=65_536)``
             over ``big_trace`` jsonl shards (64 ranks x 7,813 events,
             about 0.5M, in a temporary directory) on the card: each op
             the bits of ``Trace.open(paths)`` on the card, counts as in
             phase 5, and ``flat_profile``, ``time_profile`` and
             ``comm_matrix`` (one op a kernel but ``hist_bin``'s exact
             counts) within the gate of the CPU streaming route;
             ``flat_profile`` again at 4,999 rows a chunk, which splits
             calls across chunks, again the eager bits;
   pool    — the shared scheduler's spawn pool of ``min(os.cpu_count(),
             8)`` workers for phases 8-14, warmed up (its start-up time
             logged); every worker reports ``torch.cuda.is_initialized()``
             false;
8. pack    — main-10M written as 64 ``big_trace(format="pack")`` shards
             with structure sidecars (disk space logged first, a
             temporary directory): ``Trace.open(shards)`` and the seven
             op calls give phase 5's bits, structure derived once (the
             merge drops the shards' sidecars), while one shard opened
             alone derives none; ``scan(shards).filter(Process in 0..7)``
             reads 8 shards, skips 56, and gives the eager selection's
             bits;
             ``Trace.open(shards, streaming=True)``, serial (no structure
             derived: the sidecar slices) and over the pool, the same
             bits; counts reset and read per route, each the eager
             route's launches; one shard re-packed in 16,384-row groups
             with one flipped byte: ``verify_pack`` names the group, the
             file with its footer torn is refused under ``strict``,
             ``skip_chunk`` and ``salvage`` keep every clean group byte
             for byte;
   fold    — the same 64 shards streamed with ``fold="chunks"`` (9,942,144
             events, not cut): the seven op calls each within the gate of
             the eager route above, counts and edges exact, one launch of
             the op's kernel for every chunk that held records (64, one a
             shard), the same bits on a second call, the wall beside the
             buffered streamed route's; ``flat_profile(time.exc,
             time.inc)``'s host peak under ``tracemalloc`` (NumPy's
             allocations; mapped pack pages are not counted) on the fold
             and the buffered route over the first 8 shards opened alone
             and over all 64: the fold's at 64 at least 2x below the
             buffered one's and at most 1.5x its own at 8; then the seven
             with ``processes=`` over the pool, each within the gate of the
             serial fold, every unit's ``torch.cuda.is_initialized()``
             false;
9. parallel — stream-0.5M's jsonl shards, and the same events joined into
             one file (byte-span units cut calls, so the seam replay
             runs), through ``processes=`` work units in the pool: each
             op the eager bits of phase 7 and within the gate of the CPU
             parallel route, the eager route's launches, every unit off
             the card; a degradation warning is an error in both phases,
             and each prints pool start-up, write, open, per-op wall and
             events/s beside the card's name and power limit;
10. formats — stream-0.5M's events (phase 7's eager trace: its seven op
             calls are phase 7's digests) written as csv, chrome and an
             otf2j directory archive, and as chrome again for the first 8
             ranks (one pool worker a file, each write timed, the HLO
             check below running meanwhile): each
             opened with the format sniffed, its canonical events the
             source's and its seven op calls the source's digests; ``flat_profile`` and
             ``comm_matrix`` streamed serially (otf2j at 0.5M, chrome on
             the 8 ranks: its chunked reader decodes the JSON array
             incrementally; csv at 0.5M ``flat_profile`` only, its reader
             the slowest) and over the pool (csv ``ByteSpan``,
             otf2j and chrome ``ProcSpan`` units), the eager digest of the
             same file; a process-restricted ``flat_profile`` plan over
             the pool on chrome (ranks 0-3) and otf2j (ranks 0-15), the
             units the restriction cannot need pruned (logged), the eager
             selection's bits; launches counted per route, on the paths
             the wrappers pick; then a synthetic SPMD HLO module (a
             ``while`` over a ``dot``, an ``all-reduce``, an
             ``all-gather`` and a ``reduce-scatter``; 200,000 calls a
             device bind at 8 devices) through ``Trace.from_hlo`` with the
             H100 table: ``flat_profile``, ``comm_matrix``,
             ``time_profile`` and ``message_histogram`` on the card within
             the gate of the CPU path, the modeled step's compute,
             communication and overlap shares logged; the phase's wall
             beside the card;
11. set    — set-15M: ``TraceSet([main-10M, scale-5M])``, scale-5M
             ``big_events(nprocs=32, events_per_proc=156_250, seed=1)``
             (one application at two process counts): the five set ops
             and a mapped ``message_histogram`` on the card, each but
             ``diff_load_imbalance`` (``diff_flat_profile`` holds
             ``seg_sum``) within the gate of the CPU route (rows keyed by
             name), each carrying each member's own op bits; launches
             ``seg_sum`` 2,
             ``pair_sum`` 2, ``time_bin`` 2, ``hist_bin`` 2 (the profile
             cache answers two ``flat_profile`` passes); one ``SetQuery``
             plan (``filter(Name not-in [MpiSend])``) chaining
             ``regression_report`` and ``diff_flat_profile`` prepares
             each member once (``seg_sum`` 2) and gives the eager
             selection's bits;
12. set-stream — ``TraceSet.open([stream-0.5M's 64 shards, the first 32],
             streaming=True)``, serially and with ``processes=`` over the
             pool (every member on the scheduler's one pool, no unit on
             the card): ``regression_report``, ``diff_time_profile`` and
             ``scaling_analysis`` give the eager set's bits; with
             ``fold="chunks"`` members ``regression_report`` (``seg_sum``
             once a member's chunk) and ``scaling_analysis`` (no launch)
             within the set gate of the eager set's;
13. diagnose — the five pathologies on 64 ranks x 1,170 iterations
             (1,048,320 events): each matching detector names the ground
             truth at top 1 on the card, the clean baseline gives no
             findings; ``diagnose()`` on main-10M within the CPU route's
             findings (host detectors exact, ``stragglers`` within the
             gate), one ``seg_sum`` launch; over stream-0.5M streamed,
             pooled, from pack and streamed pack the eager digest;
14. analysis — the rest of the paper's analysis API on main-10M in memory
             on the card: twelve host-op calls (``idle_time``,
             ``comm_by_process`` by size and by count,
             ``comm_over_time``, ``comm_comp_breakdown``,
             ``logical_steps``, ``calculate_lateness``,
             ``lateness_by_process``, ``critical_path_analysis``,
             ``activity_series``, ``detect_pattern`` with and without a
             start event), each wall logged, 0 kernel launches, each the
             bits of the same call on a CPU ``Trace`` of the same events; a
             lazy plan (``filter(Name not-in [MpiSend])
             .restrict_processes(range(32))``) with ``idle_time`` and
             ``comm_over_time``, the eager selection's bits;
             ``multirun_analysis`` over ``tortuga(nprocs=n, iters=6)`` for
             n = 16, 32, 64, 128 (paper Fig. 12): ``seg_sum`` 4, private
             path, within the gate of the CPU route; over set-15M's
             members (main-10M and scale-5M): no launch (phase 11 left
             both profiles in the comparison's cache), within the gate of
             the CPU route; the
             paper's claims on the app generators at their defaults
             (``loimos``' hot ranks idle least, ``kripke_sweep``'s
             critical path crosses 4 or more ranks, ``tortuga(iters=6)``
             gives 6 ``time-loop`` patterns, ``axonn_training`` v2
             overlaps more than v0 and v1 and v2 expose less comm, and
             ``gol(imbalance=0.5)``'s maximum lateness is above 0);
             ``idle_time``, ``comm_by_process`` and ``comm_over_time`` over
             stream-0.5M pooled (``idle_time`` alone streamed serially: the
             jsonl reader's pass is the cost), the eager digest, and over
             pack-10M streamed, the main-10M digest, no launch; each of
             phases 11-14 logs its wall beside
             the card;
14b. fold hosts — pack-10M's 64 shards with ``fold="chunks"`` for
             ``idle_time``, ``comm_by_process``, ``late_sender``,
             ``serialization``, ``imbalance_root_cause``,
             ``efficiency_metrics``, ``pop_efficiency`` and ``diagnose``:
             each main-10M's eager result (phase 13's ``diagnose`` and a
             detector's rows of it, phase 14's two calls, one
             ``efficiency_metrics`` call): the host folds its bits (the
             detectors' findings exact) with no launch and no chunk
             folded, ``diagnose`` within ``findings_gate`` with
             ``seg_sum`` once a chunk (64) and its same bits on a second
             call; ``efficiency_metrics``' and ``diagnose``'s traced host
             peak on the fold and buffered routes over 8 shards and 64
             (``efficiency_metrics``: the fold's at 64 at least 2x below
             the buffered one's and at most 1.5x its own at 8;
             ``diagnose``: below the buffered one's, its ``late_sender``
             instants growing with the messages); then the eight over the
             pool, each within the gate of the serial fold, no unit on
             the card;
14c. extensions — the reference's documented extension examples,
             registered as its users write them (no ``device``
             parameter): ``diagnose()`` on main-10M with the ``gpu_idle``
             detector registered gives phase 13's findings unchanged plus
             ``gpu_idle``'s own call, ``seg_sum`` once as without it, and
             on ``gol(64 ranks, imbalance 0.8)``, where ``gpu_idle``
             fires, the built-in findings unchanged and the CPU route's
             findings; ``busiest_function`` (``groupby_agg``) and
             ``my_analysis`` on main-10M with no launch, the first the
             card's ``flat_profile`` top name; ``iteration_count_delta``
             over two baselines; stream-0.5M's 64 shards converted to a
             user format read by a device-less reader registered with
             ``iter_chunks=``: its trace on the card, a ``fold="chunks"``
             ``flat_profile`` over it the jsonl reader's bits with the
             same ``seg_sum`` launches (64), and a user
             ``register_streaming`` aggregator over it the counts read
             off the files; the registrations are removed at the end;
15. live   — with the plan cache on (phases 3-14 run with it off, so no
             stored result answers their checks), a ``TraceServer`` on
             127.0.0.1:0 on the card in a thread of this process;
             main-10M's events as 64 append-mode shards in groups of
             65,536 rows, grown in two commits a rank (the first half of
             each rank, then the rest and ``finalize``):
             ``Trace.open(shards, live=True)`` at each watermark gives, for
             the seven op calls, one digest incrementally (cache on), on a
             cold ``cache=False`` handle and eagerly over the same
             committed rows (after ``finalize``, every row: phase 5's
             digests, the eager route over the same events), each pass
             launching ``seg_sum`` 2, ``pair_sum`` 3, ``time_bin`` 1 and
             ``hist_bin`` 1 on their paths; a repeat with no growth returns
             the stored results and launches nothing; no op falls back to
             the full pass.  ``POST /live`` over 8 of the shards: 200, 429
             ``watermark_stalled`` with ``retry_after_ms``, 200 after the
             second commit.  Then a fleet of 8 ``Tracer`` ranks with sinks
             (about 20,000 enters, leaves and sends each), one heartbeat
             back-dated past ``dead_timeout``: ``LiveTraceSet`` names that
             rank missing, the survivors' seven op calls are a direct live
             open's bits, ``POST /live`` on the fleet answers 206 partial
             naming it, and ``to_traceset().regression_report()`` over
             the survivors is a set of direct live opens' bits; phase 14's
             three streamed ops at the final watermark, incrementally
             (folded on from the first watermark) and on a cold handle,
             the main-10M digest with no launch; a ``fold="chunks"`` live
             handle folded at the first watermark and re-queried after the
             growth, each of the seven within the gate of a cold fold pass,
             one launch a folded chunk (``time_profile`` and
             ``message_histogram`` need the statistics pre-pass, so take
             the full pass, counted apart from the fallbacks);
16. served — pack-10M's 64 shards (phase 8's) through ``ServiceClient``
             (``streaming=True``): ``flat_profile``, ``comm_matrix`` and
             ``message_histogram`` each the library call's digest on the
             same handle configuration (and phase 5's), the misses
             launching as a cold pass, a repeat a cache hit that launches
             nothing, and 4 identical concurrent requests executed once;
             ``open_set`` over the 64 shards and the first 32
             (``/setquery``, ``regression_report``) and ``/diagnose`` over
             the 64: the library's digests, a miss launching as the
             library call, a repeat a cache hit that launches nothing;
             ``/diagnose`` and ``/query`` of ``idle_time`` on a ``"fold":
             "chunks"`` spec: phase 14b's fold results' digests, the
             folded ``diagnose`` miss ``seg_sum`` once a chunk, ``idle_time``
             none, each repeat a hit;
             phase 14's three streamed ops, a miss the library's digest and
             a hit, neither launching; the server then drains, the live
             store is cleared and the scheduler's threads stop;
17. timing — (in the timing process) each trace kernel on the inputs
             the trace path gave it (its
             first call, and in ``other_calls`` each later call of another
             shape: ``stragglers``' ``seg_sum`` at K = 1 over 64 ranks,
             ``comm_matrix``'s ``pair_sum`` at 64 x 64): its
             time, its plain version's, one library call's (for
             ``time_bin`` a chain of calls), and its bound; a private-path
             row also times the sorted path on the same inputs and fails
             if its profiler row holds a sort kernel, the ``hist_bin`` row
             the wide path, and fails unless the narrow path is one device
             kernel a call;
18. serve  — the serving path: ``repro_torch.launch.serve`` serves 8
             requests (prompts up to 1024 tokens, 16 new tokens, batch 4,
             cache 2048) on qwen2-moe-a2.7b at full width, all 24 layers,
             bf16 weights drawn from seed 0 on the card; the model
             kernels' counts are reset just before and read just after,
             and each of the path's must have risen, every flash launch
             on the tensor-core variant and every router call (24 layers
             x 16 steps x 2 waves) on the fused ``router_topk`` kernel,
             none on ``topk_gating``; tokens in the vocabulary, finite
             logits, and the run's own trace through ``flat_profile`` on
             the card; then one prefill and one decode step under
             ``torch.profiler`` (device busy share, the largest kernels),
             the decode step's ``export_chrome_trace`` read back by the
             port's chrome reader (``on_error="skip"``, the skipped events
             counted): ``flat_profile`` on the card names the five kernels
             with the most device time, and the ``ac2g`` flows are
             ``MpiSend`` / ``MpiRecv`` rows;
19. f32    — one ``moe_ffn`` call in float32 at the serving model's
             widths (3,488 tokens, the first wave's prefill): the unfused
             route, so ``topk_gating`` is launched once, on its narrow
             path, and ``router_topk`` not at all (counts reset just
             before);
20. path   — qwen2-moe-smoke in f32 with one seeded weight set served on
             the card (kernels) and on the CPU (plain versions): the same
             greedy tokens, prefill logits within 1e-3 (phase 23 does the
             same for each of its families);
21. timing — each model kernel on the inputs its path gave it, against
             its plain version, with one library call and its bound;
             flash attention also through its SIMT variant (``prev_ms``,
             the kernel this one replaced on the path); the fused router
             also at the decode shape and beside the unfused route it
             replaced (``prev_ms``: the f32 product + ``topk_gating``);
             ``topk_gating`` also through its wide path on the same logits
             (the same bits, ``prev_ms``);
22. train  — ``repro_torch.launch.train_traced`` on pipit-lm-100m at full
             width (12 layers, d_model 768, 12 heads of 64, vocab 32,000),
             bf16 weights from seed 0, batch 16 x 256, 12 steps, a
             checkpoint every 4 (in a temporary directory, free disk
             checked first) and a fault at step 6: 1 restart, 12 steps,
             finite losses whose last 3 average below the first 3; the
             counts of every kernel reset just before and read just
             after: the flash forward and its backward kernel each 12
             layers x the steps run, every launch of both the tensor-core
             variant, ``seg_sum`` and ``time_bin`` from the run's own
             trace analysed on the
             card (``flat_profile`` names ``train_step``, ``data_wait``,
             ``checkpoint``, ``restore``), the router kernels none; ms a
             step, tokens/s and the model FLOPs' share of 989 TFLOP/s
             logged; then
             pipit-lm-100m-smoke in f32 from one seeded weight set trained
             3 steps on the card and on the CPU, losses within 1e-4; and
             (in the timing process) one step of a trainer drawn from
             seed 0 under ``torch.profiler`` and the backward kernel's row
             on the path's first backward call
             (library: SDPA's backward through autograd, timed only; the
             SIMT backward on the same inputs as ``prev_device_ms``);
23. family — gemma3-27b (62 layers: 10 x (5 local at window 1,024 + 1
             global) + 2 local), hymba-1.5b (32 layers of attention at
             window 1,024 with 128 meta tokens beside the SSD) and
             mamba2-130m (24 SSD layers) served at full width through
             ``launch.serve``, bf16 weights from seed 0: gemma3 4
             requests (prompts up to 2,048, one wave padded past the
             window, cache 4,096), hymba and mamba2 8 (prompts up to
             1,024, 2 waves, cache 2,048), 16 new tokens, batch 4; counts
             reset just before and read just after each (flash one launch
             a layer with attention a wave, all ``"wgmma"``, none for
             mamba2; no router kernel); the waves' padded lengths and
             decode positions logged (hymba's below 1,151: its meta
             positions in the ring); the first request's last decode step
             against ``LM.forward`` on its padded prompt and fed tokens
             within 5 % of the forward's largest |logit|, each greedy
             token the forward's argmax up to a tie within that; each
             family's smoke config served on the card and on the CPU as
             in phase 20; parameters, peak memory, prefill s a wave and
             decode ms a step logged, and (with the timing) a decode
             step's device busy share;
24. encdec — whisper-medium (24 encoder layers over 1,500 frames + 24
             decoder layers with cross-attention, d_model 1,024, 16 x 64
             heads, GELU; 8 requests, prompts up to its 448-token decoder
             context, cache 512, frames a seeded [4, 1,500, 1,024] bf16
             draw), phi-3-vision-4.2b (32 layers, 32 x 96 heads; 144
             image rows, a seeded [4, 144, 3,072] draw, before prompts up
             to 1,024, cache 2,048), codeqwen1.5-7b (32 layers, 32 x 128
             MHA) and qwen1.5-0.5b (24 layers, tied embeddings, vocab
             151,936; both prompts up to 1,024, cache 2,048) served at
             full width through ``launch.serve`` with ``extras``, bf16
             weights from seed 0, 16 new tokens, batch 4, 2 waves; counts
             reset just before and read just after each: flash 864
             (whisper: 2 waves x (24 encoder + 24 self + 24 cross in
             prefill + 24 cross x 15 decode steps)), 64, 64 and 48, all
             ``"wgmma"`` (phi-3-vision's at D = 96 too), no router
             kernel; the first request's last decode step against
             ``forward`` with its frames or image rows as in phase 23;
             one prefill wave and one decode step profiled (busy share,
             the flash kernels' share); each smoke config served in f32
             on the card and on the CPU with seeded extras as in phase 20;
25. giants — qwen1.5-110b (dense, 64 x 128 heads over 8 KV heads, d_ff
             49,152, vocab 152,064) and qwen3-moe-235b-a22b (64 x 128
             heads over 4 KV heads, 128 experts top-8 of width 1,536,
             served dropless: capacity factor 16) at
             full width with their depth cut to 8 layers (80 layers are
             222 GB in bf16, 94 are 470 GB; the cut is logged), served
             through ``launch.serve`` as in phase 24 (8 requests, prompts
             up to 1,024, 16 new tokens, batch 4, cache 2,048): flash one
             launch a layer a wave, all ``"wgmma"``; qwen3-moe's router
             256 ``router_topk`` launches, every call ``"fused"`` (E =
             128, k = 8: the kernel's limits); the gates of phase 24;
             qwen3-moe's first wave prefilled again at its published
             capacity factor 1.25, where the dispatch drops tokens
             (slots, ms beside the dropless wave's, finite logits, a
             profile); then qwen1.5-110b's loaded model through
             ``launch.steps.build_cell``'s prefill and decode cells on a
             (data 1, model 1) NCCL mesh (world size 1, parameters placed
             as DTensors without a copy): the first wave's greedy tokens
             and flash launches equal the unsharded run's; phase 3 adds
             flash at both groupings (H 64 over KVH 4 and 8, D = 128,
             both dtypes, bf16 on peaked draws) and the router at E =
             128, k = 8, d = 4,096 (a prefill wave with tied rows, and a
             decode step);
26. trainfam — every served config trained through ``runtime.Trainer``
             on the card at full width, its depth cut where 16 bytes a
             parameter would not fit (the cut logged): qwen2-moe-a2.7b 4
             of 24 layers, 4 x 512, 10 steps; qwen3-moe-235b-a22b 1 of
             94 and qwen1.5-110b 1 of 80, 2 x 1,024; gemma3-27b 6 of 62
             (one period), 1 x 2,048; hymba-1.5b, mamba2-130m,
             whisper-medium (2 x 448 with seeded ``frames``) and
             qwen1.5-0.5b whole; phi-3-vision-4.2b 16 of 32 (seeded
             ``img_embeds``) and codeqwen1.5-7b 8 of 32, 2 x 1,024; 3
             steps each; bf16 weights from seed 0, batches from
             ``SyntheticLMStream(seed=1)``; counts reset just before and
             read just after: flash forward and backward one launch a
             layer with attention a step (whisper 72: encoder, self and
             cross), all ``"wgmma"`` (phi-3-vision's D = 96 too); the
             router one ``router_topk`` (``"fused"``) and one
             ``topk_gating_bwd`` launch a MoE layer a step, no
             ``topk_gating`` forward; finite losses, qwen2-moe's last 3
             below its first 3; ms a step, tokens/s and peak memory
             logged; then qwen2-moe through ``launch.steps.build_cell``'s
             train cell on a (1, 1) NCCL mesh from the Trainer's
             first-step weights and batch: loss within 1e-3 relative of
             the Trainer's, the router forward and backward once a layer;
             then each config's smoke config in f32 from one seeded
             weight set, 3 steps on the card and on the CPU, losses
             within 1e-4 (the f32 router: ``topk_gating`` and its
             backward kernel).  Phase 3 holds the router backward's
             kernel to its plain version at (E, k) = (60, 4), (128, 8)
             and (256, 8), T = 1, 2,048 and 3,488, with and without an
             incoming logits gradient (tied rows, rows with fewer finite
             logits than k): the nonzero pattern exact, each value within
             1e-6 of its row's largest |g dg|, bit-identical on relaunch.

Every row's ``ms`` is CUDA events around back-to-back wrapper calls (host
overhead included where the kernel is shorter than the call);
``device_ms`` is the summed duration of the device kernels one wrapper
call launches, read from ``torch.profiler``; a model row's
``library_device_ms`` is the same for its library call.  Flash attention
has two rows: the tensor-core kernel on qwen2-moe-a2.7b's first prefill
(``flash_attention``, its launches summed over every serving run at D =
64 or 128) and at head dim 96 on phi-3-vision-4.2b's
(``flash_attention_d96``), each with the SIMT kernel on the same inputs
as ``prev_*``; two more rows time it at phase 25's
groupings on each model's first prefill (``flash_attention_gqa16``,
qwen3-moe's H 64 over KVH 4, and ``flash_attention_gqa8``,
qwen1.5-110b's H 64 over KVH 8), and ``router_topk_e128`` the fused
router on qwen3-moe's first call.  The router backward's rows,
``topk_gating_bwd`` and ``topk_gating_bwd_e128``, time it on the first
backward call of phase 26's qwen2-moe and qwen3-moe runs (and
``flash_attention_bwd_d96`` the flash backward on phi-3-vision's, the
SIMT backward as ``prev_*``, SDPA's backward as the library), beside the
library chain (the three elementwise ops, then ``scatter_add_`` into
zeros), after one qwen2-moe train step profiled (busy share, the
router forward's and backward's shares of device time).  The rows of
``seg_sum``, ``pair_sum``, ``time_bin``, ``hist_bin`` and ``topk_gating``
name their
``path`` and time the path it replaced on the same inputs (``prev_path``,
``prev_ms``, ``prev_device_ms``); the four trace rows also give their
launches on the query, stream, pack, fold, parallel, formats, set,
diagnose, analysis, live and served routes (``route_launches``; a cache
hit's are 0, and so are the host ops' of phase 14).  Each trace-half
phase logs its wall (``[<phase>] phase wall``).

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  It imports nothing of the JAX
reference package.  Without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.launch.cardcheck import (  # noqa: E402
    HBM_BYTES_PER_S, card_line, cuda_ms, device_ms, exact, flash_bwd_tol,
    flash_draw, flash_forward_lse, flash_gate_share, gate, same_bits,
    topk_bwd_bound_ms, topk_bwd_err)

F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
MAIN = dict(nprocs=64, events_per_proc=156_250, seed=0)
ARCH = "qwen2-moe-a2.7b"
SERVE = dict(arch=ARCH, requests=8, batch=4, prompt_len=1024,
             new_tokens=16, cache_len=2048, dtype="bfloat16")


#: the card's name and power limit (``nvidia-smi``), set by phase 1 and
#: printed beside every time the pack and parallel phases log
SMI = ["card not read yet"]


_LOG_LOCK = threading.Lock()


def log(*parts) -> None:
    """One line to standard output, whole: the LM half's forwarded lines
    come from another thread."""
    text = " ".join(map(str, parts)) + "\n"
    with _LOG_LOCK:
        sys.stdout.write(text)
        sys.stdout.flush()


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = SMI[0] = card_line()
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)
    return {"kind": name, "count": count, "smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import build
    build.library()
    log(f"[build] {build.BUILD_SECONDS:.2f} s into {build.BUILD_DIR}")
    for line in build.BUILD_LOG.splitlines():
        if any(k in line for k in ("==", "Compiling entry", "registers",
                                   "spill", "smem")):
            log("[ptxas]", line.strip())


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions on the card
# ---------------------------------------------------------------------------

def _dev(x):
    return torch.from_numpy(np.ascontiguousarray(x)).cuda()


def _seg_case(rng, n, n_seg, k, pad=0.0, runs=False):
    code = rng.integers(0, n_seg, size=n).astype(np.int32)
    code[rng.random(n) < pad] = -1
    if runs:                     # long runs of one code
        code = np.sort(code)
    vals = rng.integers(5_000, 40_000, size=(n, k)).astype(np.float32)
    return _dev(code), _dev(vals), n_seg


def _pair_case(rng, n, n_a, n_b, pad=0.0, runs=False):
    a = rng.integers(0, n_a, size=n).astype(np.int32)
    b = rng.integers(0, n_b, size=n).astype(np.int32)
    a[rng.random(n) < pad] = -1
    if runs:                     # by rank, then name: the ops' long runs
        o = np.lexsort((a, b))
        a, b = a[o], b[o]
    w = rng.integers(256, 8192, size=n).astype(np.float32)
    return _dev(a), _dev(b), _dev(w), n_a, n_b


def _time_case(rng, n, n_funcs, n_bins, zero=0.0, pad=0.0, runs=False,
               nonfinite=False):
    s = rng.random(n) * n_bins
    d = rng.exponential(2e-3, size=n)
    d[rng.random(n) < 0.001] *= 5000           # a few long calls
    d[rng.random(n) < zero] = 0.0              # zero-duration calls
    if runs:                                   # canonical order: by start
        s = np.sort(s)
    e = np.minimum(s + d, n_bins)
    f = rng.integers(0, n_funcs, size=n).astype(np.int32)
    f[rng.random(n) < pad] = -1
    r = (rng.integers(5_000, 40_000, size=n) / np.maximum(d, 1e-9)
         * (d > 0))
    s, e, r = s.astype(np.float32), e.astype(np.float32), \
        (r * 1e-6).astype(np.float32)
    if nonfinite:          # infinite ends clamp; NaN fills func 1's row
        s[::1001], e[::1003] = -np.inf, np.inf
        s[5::2003], e[7::2003] = np.inf, -np.inf
        s[11::20011] = np.nan
        e[13::30011] = np.nan
        f[11::20011] = f[13::30011] = 1
    return (_dev(s), _dev(e), _dev(f), _dev(r), n_funcs, n_bins, 0.0,
            float(n_bins))


def _hist_case(rng, n, n_bins, pad=0.0, edges=False, offset=0):
    """``offset`` > 0 starts the coordinates that many floats past a
    16-byte boundary (the narrow path's scalar head)."""
    x = rng.integers(0, n_bins, size=n + offset) + 0.5
    x[rng.random(n + offset) < pad] = -1.0
    if edges:         # +inf and 3e9 in the top bin, -0.0 in bin 0, NaN and
        x[1::17], x[2::17], x[3::17] = np.inf, 3e9, -0.0       # -inf out
        x[4::17], x[5::17] = np.nan, -np.inf
    return _dev(x.astype(np.float32))[offset:], n_bins


def phase_kernels() -> None:
    """The trace kernels: ``seg_sum``, ``time_bin`` and ``pair_sum`` case by
    case through :func:`check_paths`, ``hist_bin`` through the path its
    wrapper picks and the wide one against its plain version (counts
    exact, bit-identical on relaunch)."""
    from repro_torch.kernels import hist_bin
    rng = np.random.default_rng(0)
    paths = {
        "seg_sum": [
            ("main 4.3M x2, 6 names", _seg_case(rng, 4_300_000, 6, 2)),
            ("1024 names", _seg_case(rng, 4_300_000, 1024, 1)),
            ("N=1", _seg_case(rng, 1, 5, 2)),
            ("N=1000, padded", _seg_case(rng, 1000, 7, 3, pad=0.2)),
            ("all codes < 0", _seg_case(rng, 5000, 7, 1, pad=1.0)),
            ("K=11", _seg_case(rng, 20_000, 9, 11)),
            ("K=8", _seg_case(rng, 200_000, 6, 8)),
            ("6 names x2, in runs", _seg_case(rng, 4_300_000, 6, 2,
                                              runs=True)),
            ("threshold 3072 x 2", _seg_case(rng, 500_000, 3072, 2)),
            ("above it, 6145 names", _seg_case(rng, 500_000, 6145, 1)),
        ],
        "time_bin": [
            ("main 4.3M, 32 bins", _time_case(rng, 4_300_000, 6, 32)),
            ("1024 bins", _time_case(rng, 500_000, 13, 1024)),
            ("N=1", _time_case(rng, 1, 3, 8)),
            ("N=1000, zero-duration", _time_case(rng, 1000, 7, 10,
                                                 zero=0.3, pad=0.1)),
            ("all funcs < 0", _time_case(rng, 5000, 7, 10, pad=1.0)),
            ("32 bins, in runs", _time_case(rng, 4_300_000, 6, 32,
                                            runs=True)),
            ("NaN and inf coordinates", _time_case(rng, 500_000, 6, 32,
                                                   nonfinite=True)),
            ("threshold 48 x 128", _time_case(rng, 500_000, 48, 128)),
            ("above it, 5 x 1229", _time_case(rng, 500_000, 5, 1229)),
        ],
    }
    hist = [
        ("main 0.7M, 10 bins", _hist_case(rng, 700_000, 10)),
        ("1024 bins", _hist_case(rng, 700_000, 1024)),
        ("20000 bins", _hist_case(rng, 700_000, 20_000)),
        ("N=1", _hist_case(rng, 1, 4)),
        ("N=1000, padded", _hist_case(rng, 1000, 7, pad=0.2)),
        ("all < 0", _hist_case(rng, 5000, 7, pad=1.0)),
        ("+inf 3e9 -0.0 NaN, N=500003", _hist_case(rng, 500_003, 10,
                                                   edges=True)),
        ("edges, N=7", _hist_case(rng, 7, 3, edges=True)),
        ("N=1, +inf", (_dev(np.array([np.inf], np.float32)), 5)),
        ("N=1, -0.0", (_dev(np.array([-0.0], np.float32)), 5)),
        ("N=1, NaN", (_dev(np.array([np.nan], np.float32)), 5)),
        ("N=2, off 16 bytes", _hist_case(rng, 2, 6, offset=1)),
        ("N=100001, off 16 bytes", _hist_case(rng, 100_001, 10, edges=True,
                                              offset=3)),
        ("32 bins", _hist_case(rng, 700_000, 32)),
        ("33 bins", _hist_case(rng, 700_000, 33)),
        ("1 bin", _hist_case(rng, 70_000, 1, pad=0.1)),
    ]
    rng = np.random.default_rng(2)
    paths["pair_sum"] = [
        ("main ranks x ranks 0.7M", _pair_case(rng, 700_000, 64, 64)),
        ("main names x ranks 4.3M", _pair_case(rng, 4_300_000, 6, 64)),
        ("names x ranks, in runs", _pair_case(rng, 4_300_000, 6, 64,
                                              runs=True)),
        ("64 x 64, 30% ignored", _pair_case(rng, 700_000, 64, 64,
                                            pad=0.3)),
        ("threshold 96 x 64", _pair_case(rng, 1_000_000, 96, 64)),
        ("above it, 5 x 1229", _pair_case(rng, 1_000_000, 5, 1229)),
        ("1024 x 1024", _pair_case(rng, 4_300_000, 1024, 1024)),
        ("2048 x 2048", _pair_case(rng, 4_300_000, 2048, 2048)),
        ("2048 x 2048, 30% ignored", _pair_case(rng, 4_300_000, 2048, 2048,
                                                pad=0.3)),
        ("N=1", _pair_case(rng, 1, 3, 3)),
        ("N=1000, padded", _pair_case(rng, 1000, 5, 7, pad=0.2)),
        ("all codes < 0", _pair_case(rng, 5000, 5, 7, pad=1.0)),
    ]
    for name, items in paths.items():
        for label, args in items:
            check_paths(name, label, args)
        if PATHS_SEEN[name] != {"private", "sorted"}:
            raise AssertionError(f"{name} paths checked {PATHS_SEEN[name]}")
    seen = set()
    for label, args in hist:
        picked = hist_bin.path(args[1])
        want = hist_bin.hist_bin_plain(*args).cpu().numpy()
        for p in dict.fromkeys((picked, "wide")):
            got = hist_bin.hist_bin_path(p, *args)
            again = hist_bin.hist_bin_path(p, *args)
            torch.cuda.synchronize()
            if not same_bits(got, again):
                raise AssertionError(f"hist_bin [{label}, {p}]: relaunch "
                                     f"differs")
            exact(got.cpu().numpy(), want)
            seen.add(p)
            log(f"[kernels] hist_bin {label:28s} {p:6s}"
                f"{' (picked)' if p == picked else '         '} ok  counts "
                f"exact  bit-identical relaunch")
    if seen != set(hist_bin.PATH_LAUNCHES):
        raise AssertionError(f"hist_bin paths checked {seen}")


#: the kernels with a private and a sorted path, and the paths checked
PATH_KERNELS = ("seg_sum", "pair_sum", "time_bin")
PATHS_SEEN = {name: set() for name in PATH_KERNELS}
#: the path every main-path call of a trace kernel must take
MAIN_PATHS = {"seg_sum": "private", "pair_sum": "private",
              "time_bin": "private", "hist_bin": "narrow"}
#: the design each path replaced on its path: timed on the same inputs
PREV_PATH = {"private": "sorted", "narrow": "wide"}


def _n_cells(name, args) -> tuple:
    """(records, grid cells) of a path kernel's positional arguments."""
    if name == "seg_sum":
        return args[0].shape[0], args[2] * args[1].shape[1]
    if name == "pair_sum":
        return args[0].shape[0], args[3] * args[4]
    return args[0].shape[0], args[4] * args[5]


def check_paths(name, label, args) -> None:
    """A path kernel through the path its wrapper picks and, where the grid
    fits the private path, also through the sorted one: each bit-identical
    on relaunch and within the gate of the plain version."""
    from repro_torch import kernels
    mod = getattr(kernels, name)
    run, plain = getattr(mod, name + "_path"), getattr(mod, name + "_plain")
    picked = mod.path(*_n_cells(name, args))
    want = plain(*args).cpu().numpy()
    for p in dict.fromkeys((picked, "sorted")):
        got = run(p, *args)
        again = run(p, *args)
        torch.cuda.synchronize()
        if not same_bits(got, again):
            raise AssertionError(f"{name} [{label}, {p}]: relaunch differs")
        err = gate(got.cpu().numpy(), want)
        PATHS_SEEN[name].add(p)
        log(f"[kernels] {name} {label:26s} {p:7s}"
            f"{' (picked)' if p == picked else '         '} ok  "
            f"max_abs_err={err:.6g}  bit-identical relaunch")


def _flash_case(rng, B, Sq, Sk, H, KVH, D, dtype, peaked=False, **kw):
    """q, k, v on the card from :func:`flash_draw` (``peaked``: outputs of
    order one) and the kernel's keywords."""
    q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in flash_draw(
        rng, (B, Sq, H, D), (B, Sk, KVH, D), peaked))
    return (q, k, v), kw


def _topk_case(rng, T, E, k, ties=False, fill=None):
    """``fill``: every other row set to that value (``-inf`` and values at
    or below -1e30 select a chosen column again), the rows between at or
    below -1e30 too."""
    x = rng.standard_normal((T, E)).astype(np.float32)
    if ties:
        x[::2, 3::4] = 2.5                   # exact ties among the largest
        x[1::2] = np.round(x[1::2])          # tied integers, signed zeros
    if fill is not None:
        x[::2] = fill
        x[1::2] = -1e30 - np.abs(x[1::2]) * 1e30
    return (_dev(x), k), {}


def _router_case(rng, T, d, E, k, zero_rows=False):
    """bf16 activations ~ N(0, 1) (what rms_norm hands the router) and a
    router weight drawn as the model draws it (std d^-1/2)."""
    x = rng.standard_normal((T, d)).astype(np.float32)
    if zero_rows:
        x[::7] = 0.0                 # all-zero logits: every expert ties
    w = (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32)
    return _dev(x).bfloat16(), _dev(w).bfloat16(), k


def check_router(label, x, w, k) -> float:
    """The fused router against its plain version on the card: bit-identical
    on relaunch; idx equal to and gates within 1e-6 of ``topk_gating_plain``
    on the kernel's own logits; logits within ``logit_tolerance`` of the
    float32 product; and every row whose indices differ from the plain
    route's must differ where two of the plain logits lie within twice
    that tolerance of each other (each may move by it).  Returns the
    logits' max abs error."""
    from repro_torch.kernels import router_topk as rt
    from repro_torch.kernels import topk_gating as tg
    got = rt.router_topk(x, w, k)
    again = rt.router_topk(x, w, k)
    want_logits, want_idx, _want_gates = rt.router_topk_plain(x, w, k)
    tol = rt.logit_tolerance(x, w)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError(f"router_topk [{label}]: relaunch differs")
    logits, idx, gates = got
    own_idx, own_gates = tg.topk_gating_plain(logits, k)
    exact(idx.cpu().numpy(), own_idx.cpu().numpy())
    gate_err = within(1e-6)(gates.cpu().numpy(), own_gates.cpu().numpy())
    diff = (logits - want_logits).abs()
    if not bool((diff <= tol).all()):
        raise AssertionError(f"router_topk [{label}]: logits outside the "
                             f"tolerance, max abs err {float(diff.max())}")
    err = float(diff.max())
    ratio = float((diff / tol.clamp_min(1e-30)).max())
    rows = (idx != want_idx).any(dim=1).nonzero().flatten()
    if len(rows):
        first = (idx[rows] != want_idx[rows]).int().argmax(dim=1)
        pl = want_logits[rows]
        a = pl.gather(1, want_idx[rows, first].long()[:, None])
        b = pl.gather(1, idx[rows, first].long()[:, None])
        gap = (a - b).abs().flatten()
        if not bool((gap <= 2 * tol[rows].amax(dim=1)).all()):
            raise AssertionError(f"router_topk [{label}]: {len(rows)} rows "
                                 f"route differently with logit gaps above "
                                 f"the tolerance")
    log(f"[kernels] router_topk {label:34s} ok  idx exact and gates "
        f"max_abs_err={gate_err:.3g} on its own logits; logits "
        f"max_abs_err={err:.3g} ({ratio:.3g} of the tolerance); "
        f"{len(rows)}/{len(idx)} rows route differently from the plain "
        f"logits, each within the tolerance; bit-identical relaunch")
    return err


def within(tol):
    """Max abs error of a kernel result against its plain version; raises
    above ``tol``."""
    def check(a, b):
        err = float(np.abs(np.asarray(a, np.float64)
                           - np.asarray(b, np.float64)).max()) \
            if np.asarray(a).size else 0.0
        if not err <= tol:
            raise AssertionError(f"max abs err {err} above {tol}")
        return err
    return check


def phase_model_kernels() -> None:
    """Flash attention within 2e-5 (f32) / 3e-2 (bf16) of its plain
    version, top-k indices exact and gates within 1e-6 (the tolerances of
    tests/test_kernels.py), the fused router as :func:`check_router`
    holds it; every case bit-identical on relaunch.  The peaked flash
    cases (bf16) also hold their gate to at most a tenth of the plain
    output's mean magnitude (:func:`flash_gate_share`).  Each bf16 flash case
    at D = 64, 96 or 128 runs through both variants: the tensor-core one
    (what the wrapper picks) and the SIMT one.  Each top-k case runs through the
    path the wrapper picks and the wide one, whose bits must be equal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import topk_gating as tg
    rng = np.random.default_rng(1)
    flash, peaked = [], []
    for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        flash += [
            (f"{tag} serve 4x1024x16x128 causal", tol,
             _flash_case(rng, 4, 1024, 1024, 16, 16, 128, dtype)),
            (f"{tag} window 64 + prefix 8", tol,
             _flash_case(rng, 2, 1024, 1024, 16, 16, 128, dtype,
                         window=64, prefix_len=8)),
            (f"{tag} non-causal", tol,
             _flash_case(rng, 2, 512, 700, 8, 8, 128, dtype, causal=False)),
            (f"{tag} GQA H/KVH=4", tol,
             _flash_case(rng, 2, 512, 512, 16, 4, 128, dtype)),
            (f"{tag} padded tail S=1000", tol,
             _flash_case(rng, 2, 1000, 1000, 16, 16, 128, dtype)),
            (f"{tag} Sq=1 at position 1999", tol,
             _flash_case(rng, 4, 1, 2000, 16, 16, 128, dtype,
                         q_offset=1999)),
            (f"{tag} smoke width D=16", tol,
             _flash_case(rng, 4, 33, 33, 4, 4, 16, dtype)),
            (f"{tag} D=64 S=1000", tol,
             _flash_case(rng, 2, 1000, 1000, 8, 8, 64, dtype)),
            (f"{tag} D=64 GQA 4, window 64 + prefix 8", tol,
             _flash_case(rng, 1, 40, 1300, 8, 2, 64, dtype, q_offset=1260,
                         window=64, prefix_len=8)),
            # gemma3-27b's local layers: H 32 over KVH 16, window 1,024
            (f"{tag} gemma3 local 2x2048 H32/KV16 D=128 window 1024", tol,
             _flash_case(rng, 2, 2048, 2048, 32, 16, 128, dtype,
                         window=1024)),
            # hymba-1.5b: H 25 over KVH 5 (G = 5), window 1,024 + 128 meta
            # keys; rows past 1,151 put the window's edge inside a key tile
            # beyond the prefix
            (f"{tag} hymba 2x1300 H25/KV5 D=64 window 1024 + prefix 128",
             tol, _flash_case(rng, 2, 1300, 1300, 25, 5, 64, dtype,
                              window=1024, prefix_len=128)),
        ]
        # qwen3-moe-235b-a22b (a GQA group of 16) and qwen1.5-110b (8) over
        # 1,024 causal keys, whisper-medium's encoder over 1,500 frames (a
        # padded tail, no other mask), its cross-attention from the
        # decoder's prompt and from one decode row at D = 64, and
        # phi-3-vision's prefill (144 image + 1,024 prompt rows) at D = 96.
        # In bf16 on peaked draws (outputs of order one, so the gate is a
        # small share of them; checked by flash_gate_share); f32's gate is
        # already a small share of the standard draws' outputs
        bf16 = dtype == torch.bfloat16
        (peaked if bf16 else flash).extend([
            (f"{tag} qwen3-moe 2x1024 H64/KV4 D=128 causal", tol,
             _flash_case(rng, 2, 1024, 1024, 64, 4, 128, dtype, bf16)),
            (f"{tag} qwen1.5-110b 2x1024 H64/KV8 D=128 causal", tol,
             _flash_case(rng, 2, 1024, 1024, 64, 8, 128, dtype, bf16)),
            (f"{tag} whisper encoder 4x1500x16x64 non-causal", tol,
             _flash_case(rng, 4, 1500, 1500, 16, 16, 64, dtype, bf16,
                         causal=False)),
            (f"{tag} whisper cross 4x448 over 1500 frames", tol,
             _flash_case(rng, 4, 448, 1500, 16, 16, 64, dtype, bf16,
                         causal=False)),
            (f"{tag} whisper cross decode 4x1 over 1500 frames", tol,
             _flash_case(rng, 4, 1, 1500, 16, 16, 64, dtype, bf16,
                         causal=False)),
            (f"{tag} phi-3 4x1168x32x96 causal", tol,
             _flash_case(rng, 4, 1168, 1168, 32, 32, 96, dtype, bf16)),
        ])
    topk = [
        ("serve T=4096 E=60 k=4", _topk_case(rng, 4096, 60, 4)),
        ("E=128 k=8", _topk_case(rng, 2048, 128, 8)),
        ("ragged T=4099", _topk_case(rng, 4099, 60, 4)),
        ("exact ties", _topk_case(rng, 4096, 60, 4, ties=True)),
        ("decode T=4", _topk_case(rng, 4, 60, 4)),
        ("rows of -inf", _topk_case(rng, 1000, 60, 4, fill=-np.inf)),
        ("rows at -1e30", _topk_case(rng, 1000, 60, 8, fill=-1e30)),
        ("E=5 k=1", _topk_case(rng, 3001, 5, 1, ties=True)),
        ("E=5 k=5", _topk_case(rng, 3001, 5, 5, ties=True)),
        ("E=33 k=8", _topk_case(rng, 3001, 33, 8, ties=True)),
        ("E=64 k=4", _topk_case(rng, 3001, 64, 4, ties=True)),
        ("E=127 k=8", _topk_case(rng, 3001, 127, 8, ties=True)),
        ("E=128 k=1", _topk_case(rng, 3001, 128, 1, ties=True)),
        ("E=129 k=8", _topk_case(rng, 1001, 129, 8, ties=True)),
        ("E=300 k=2", _topk_case(rng, 1001, 300, 2)),
    ]
    router = [
        ("serve prefill T=3488 d=2048 E=60 k=4",
         _router_case(rng, 3488, 2048, 60, 4)),
        ("serve decode T=4", _router_case(rng, 4, 2048, 60, 4)),
        ("E=128 k=8 d=1024", _router_case(rng, 2048, 1024, 128, 8)),
        ("ragged T=3489 d=2064 E=61 k=3",
         _router_case(rng, 3489, 2064, 61, 3)),
        ("all-zero rows (ties)", _router_case(rng, 700, 2048, 60, 4,
                                              zero_rows=True)),
        ("depth split T=250 d=2064 E=61 k=3",
         _router_case(rng, 250, 2064, 61, 3)),
        # qwen3-moe-235b-a22b: the kernel's limits, E = 128 and k = 8
        ("qwen3 T=4096 d=4096 E=128 k=8 ties",
         _router_case(rng, 4096, 4096, 128, 8, zero_rows=True)),
        ("qwen3 decode T=4 d=4096 E=128 k=8",
         _router_case(rng, 4, 4096, 128, 8)),
    ]
    seen = set()
    for label, tol, (args, kw), is_peaked in (
            [c + (False,) for c in flash] + [c + (True,) for c in peaked]):
        picked = fa.variant(args[0].dtype, args[0].shape[-1])
        want = fa.flash_attention_plain(*args, **kw)
        share = (f", {flash_gate_share(tol, want):.3g} of mean |out|"
                 if is_peaked else "")
        for name in dict.fromkeys((picked, "simt")):
            run = (fa.flash_attention if name == picked else
                   lambda *a, _n=name, **k: fa.flash_attention_variant(
                       _n, *a, **k))
            got = run(*args, **kw)
            again = run(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash_attention [{label}, {name}]: "
                                     f"relaunch differs")
            err = within(tol)(got.float().cpu().numpy(),
                              want.float().cpu().numpy())
            seen.add(name)
            log(f"[kernels] flash_attention {label:52s} {name:5s}"
                f"{' (picked)' if name == picked else '         '} ok  "
                f"max_abs_err={err:.6g} (tol {tol:g}{share})  "
                f"bit-identical relaunch")
    if seen != set(fa.VARIANT_LAUNCHES):
        raise AssertionError(f"flash variants checked {seen}, have "
                             f"{set(fa.VARIANT_LAUNCHES)}")
    check_flash_bwd(rng)
    seen = set()
    for label, (args, kw) in topk:
        picked = tg.path(args[0].shape[1])
        widx, wgates = tg.topk_gating_plain(*args)
        got = {}
        for p in dict.fromkeys((picked, "wide")):
            got[p] = tg.topk_gating_path(p, *args)
            again = tg.topk_gating_path(p, *args)
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip(got[p], again)):
                raise AssertionError(f"topk_gating [{label}, {p}]: relaunch "
                                     f"differs")
            idx, gates = got[p]
            exact(idx.cpu().numpy(), widx.cpu().numpy())
            err = within(1e-6)(gates.cpu().numpy(), wgates.cpu().numpy())
            seen.add(p)
            log(f"[kernels] topk_gating {label:24s} {p:6s}"
                f"{' (picked)' if p == picked else '         '} ok  indices "
                f"exact, gates max_abs_err={err:.6g}  bit-identical relaunch")
        if not all(same_bits(a, b) for a, b in zip(got[picked],
                                                   got["wide"])):
            raise AssertionError(f"topk_gating [{label}]: the {picked} "
                                 f"path's bits differ from the wide path's")
    if seen != set(tg.PATH_LAUNCHES):
        raise AssertionError(f"topk_gating paths checked {seen}")
    _topk_nan_row(tg)
    check_topk_bwd(rng)
    for label, args in router:
        check_router(label, *args)


#: the router backward's cases in phase 3: (E, k) of qwen2-moe-a2.7b,
#: qwen3-moe-235b-a22b and the wide top-k path, at these token counts
TOPK_BWD_CASES = ((60, 4), (128, 8), (256, 8))
TOPK_BWD_T = (1, 2048, 3488)


def check_topk_bwd(rng) -> None:
    """The router backward's kernel against its plain version on the card,
    on the forward kernel's indices and gates of logits with tied rows and
    rows with fewer finite logits than k (one finite logit, or none: a
    column chosen again, whose slots' contributions add up), with and
    without an incoming gradient of the logits: the nonzero pattern exact,
    each value within 1e-6 of its row's largest |g_j dg_j|
    (``cardcheck.topk_bwd_err``), bit-identical on relaunch."""
    from repro_torch.kernels import topk_gating as tg
    for E, k in TOPK_BWD_CASES:
        for T in TOPK_BWD_T:
            x = rng.standard_normal((T, E)).astype(np.float32)
            x[::4, 3::4] = 2.5               # exact ties among the largest
            x[1::4] = np.round(x[1::4])      # tied integers
            x[3::11, 1:] = -np.inf           # one finite logit
            x[5::11] = -np.inf               # none
            idx, gates = tg.topk_gating(_dev(x), k)
            dg = _dev(rng.standard_normal((T, k)).astype(np.float32))
            dup = sum(len(set(r)) < k for r in idx.tolist())
            for incoming in (False, True):
                din = _dev(rng.standard_normal((T, E)).astype(
                    np.float32)) if incoming else None
                got = tg.topk_gating_bwd(idx, gates, dg, din, E=E)
                again = tg.topk_gating_bwd(idx, gates, dg, din, E=E)
                torch.cuda.synchronize()
                label = (f"T={T} E={E} k={k} "
                         f"{'+ dlogits' if incoming else 'alone'}")
                if not same_bits(got, again):
                    raise AssertionError(f"topk_gating_bwd [{label}]: "
                                         f"relaunch differs")
                want = tg.topk_gating_bwd_plain(idx, gates, dg, din, E=E)
                err = topk_bwd_err(got, want, gates, dg)
                log(f"[kernels] topk_gating_bwd {label:30s} ok  nonzero "
                    f"pattern exact, max_abs_err={err:.3g} (tol 1e-6 x the "
                    f"row's largest |g dg|), {dup} rows with a column "
                    f"chosen again; bit-identical relaunch")


def flash_bwd_err(got, want, label) -> tuple:
    """(dq, dk, dv) against the plain version's, each within
    ``flash_bwd_tol`` (2e-5 in f32, 3e-2 in bf16, times that gradient's
    largest magnitude); raises outside it.  Returns the max abs error and
    each gradient's (error, limit)."""
    each = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        e = float((g.float() - w.float()).abs().max())
        tol = flash_bwd_tol(g.dtype, w)
        if not e <= tol:
            raise AssertionError(f"flash_attention_bwd [{label}] {name}: "
                                 f"max abs err {e} above {tol}")
        each[name] = (e, tol)
    return max(e for e, _t in each.values()), each


def check_flash_bwd(rng) -> None:
    """The backward kernel against its plain version on the card, on the
    output and row log-sum-exp of the forward kernel the wrapper picks:
    the training shape and the edge cases in bf16 and f32, D = 64, 96
    and 128, each bf16 case at D = 64, 96 or 128 through both variants
    (the picked one through the wrapper); bit-identical on relaunch."""
    from repro_torch.kernels import flash_attention as fa
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases += [
            (f"{tag} train 16x256x12x64 causal",
             _flash_case(rng, 16, 256, 256, 12, 12, 64, dtype)),
            (f"{tag} GQA H/KVH=4 D=128",
             _flash_case(rng, 2, 512, 512, 16, 4, 128, dtype)),
            (f"{tag} window 64 + prefix 8 D=128",
             _flash_case(rng, 2, 1024, 1024, 8, 8, 128, dtype, window=64,
                         prefix_len=8)),
            (f"{tag} padded tail S=1000 D=64",
             _flash_case(rng, 2, 1000, 1000, 8, 8, 64, dtype)),
            (f"{tag} D=64 GQA 4, window 64 + prefix 8, offset",
             _flash_case(rng, 1, 40, 1300, 8, 2, 64, dtype, q_offset=1260,
                         window=64, prefix_len=8)),
            (f"{tag} phi-3 4x1168x32x96 causal",
             _flash_case(rng, 4, 1168, 1168, 32, 32, 96, dtype)),
            # phase 26's first backwards at full width: the GQA groups of
            # qwen3-moe (16) and qwen1.5-110b (8), gemma3's local window,
            # whisper's non-causal cross-attention at Sq != Sk
            (f"{tag} qwen3-moe GQA 16 1x1024 H64/KV4 D=128",
             _flash_case(rng, 1, 1024, 1024, 64, 4, 128, dtype)),
            (f"{tag} qwen1.5-110b GQA 8 1x1024 H64/KV8 D=128",
             _flash_case(rng, 1, 1024, 1024, 64, 8, 128, dtype)),
            (f"{tag} gemma3 local 1x2048 H32/KV16 D=128 window 1024",
             _flash_case(rng, 1, 2048, 2048, 32, 16, 128, dtype,
                         window=1024)),
            (f"{tag} whisper cross 2x448 over 1500 frames D=64",
             _flash_case(rng, 2, 448, 1500, 16, 16, 64, dtype,
                         causal=False)),
            (f"{tag} hymba 1x1300 H25/KV5 D=64 window 1024 + prefix 128",
             _flash_case(rng, 1, 1300, 1300, 25, 5, 64, dtype, window=1024,
                         prefix_len=128)),
        ]
    for label, ((q, k, v), kw) in cases:
        o, lse = flash_forward_lse(q, k, v, **kw)
        do = torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(
            np.float32)).cuda().to(q.dtype)
        want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
        picked = fa.variant_bwd(q.dtype, q.shape[-1])
        for name in dict.fromkeys((picked, "simt")):
            run = (fa.flash_attention_bwd if name == picked else
                   lambda *a, _n=name, **k: fa.flash_attention_bwd_variant(
                       _n, *a, **k))
            got = run(q, k, v, o, do, lse, **kw)
            again = run(q, k, v, o, do, lse, **kw)
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd [{label}, "
                                     f"{name}]: relaunch differs")
            err, each = flash_bwd_err(got, want, f"{label}, {name}")
            log(f"[kernels] flash_attention_bwd {label:42s} {name:5s}"
                f"{' (picked)' if name == picked else '         '} ok  "
                f"max_abs_err={err:.6g} (tol {each['dq'][1]:.3g} on dq)  "
                f"bit-identical relaunch")


def _topk_nan_row(tg) -> None:
    """A row holding NaN has no defined top k (the ops never feed one): log
    what each path and the plain version give, and check nothing."""
    x = torch.tensor([[0.5, float("nan"), 2.0, -1.0, 2.0, 0.25]] * 3,
                     device="cuda")
    x[1, 0] = float("nan")
    for p in ("narrow", "wide"):
        idx, gates = tg.topk_gating_path(p, x, 3)
        log(f"[kernels] topk_gating NaN rows {p:6s} idx {idx.tolist()} "
            f"gates {gates.tolist()} (not checked)")
    idx, gates = tg.topk_gating_plain(x, 3)
    log(f"[kernels] topk_gating NaN rows plain  idx {idx.tolist()} gates "
        f"{gates.tolist()} (not checked)")


# ---------------------------------------------------------------------------
# phases 4-5: the ops on the card against the CPU path
# ---------------------------------------------------------------------------

OPS = [
    ("flat_profile", {"metrics": ("time.exc", "time.inc")}),
    ("flat_profile", {"per_process": True}),
    ("time_profile", {"num_bins": 32}),
    ("load_imbalance", {}),
    ("comm_matrix", {}),
    ("message_histogram", {"bins": 10}),
    # -1 reports every rank (a severity of -1 or more is a work of 0 or
    # more), so the checks see every rank's busy sum
    ("stragglers", {"threshold": -1.0}),
]


def _canonical(frame):
    """Rows in key order (Name, then Process): sums that tie to within f32
    rounding may sort either way in the op's own metric order."""
    keys = [c for c in ("Process", "Name") if c in frame.columns]
    cols = [np.asarray(frame.column(c).codes if c == "Name"
                       else frame[c]) for c in keys]
    return frame.take(np.lexsort(cols)) if cols else frame


def same_findings(a, b) -> float:
    """Two Findings frames by rank: the same rows, windows exact and
    severities within the gate (explanations quote the f32 sums rounded to
    the microsecond, so they are not compared)."""
    ka, kb = (np.argsort(np.asarray(f["process"]), kind="stable")
              for f in (a, b))
    for c in ("detector", "location", "process", "function", "t_start",
              "t_end"):
        if not np.array_equal(np.asarray(a[c])[ka], np.asarray(b[c])[kb]):
            raise AssertionError(f"stragglers: column {c} differs")
    return gate(np.asarray(a["severity"])[ka], np.asarray(b["severity"])[kb])


def same_result(op, a, b) -> float:
    """The port's op on the card vs on the CPU: sums within the gate,
    counts, edges, names and histogram counts exact."""
    if op == "comm_matrix":
        return gate(a, b)
    if op == "message_histogram":
        exact(a[1], b[1])
        return exact(a[0], b[0])
    if op == "stragglers":
        return same_findings(a, b)
    if sorted(a.columns) != sorted(b.columns) or len(a) != len(b):
        raise AssertionError(f"{op}: columns / rows differ: {a.columns} "
                             f"{len(a)} vs {b.columns} {len(b)}")
    a, b = _canonical(a), _canonical(b)
    floats = [c for c in b.columns if np.asarray(b[c]).dtype.kind == "f"]
    scale = max([1.0] + [float(np.abs(np.asarray(b[c])).max())
                         for c in floats if len(b)])
    err = 0.0
    for c in b.columns:
        va, vb = np.asarray(a[c]), np.asarray(b[c])
        if c in floats:
            if not np.allclose(va, vb, rtol=1e-4, atol=1e-6 * scale):
                raise AssertionError(f"{op}: column {c} outside the gate")
            err = max(err, float(np.abs(va - vb).max()) if len(va) else 0.0)
        elif va.dtype == object:
            if not all(list(x) == list(y) for x, y in zip(va, vb)):
                raise AssertionError(f"{op}: column {c} differs")
        elif not np.array_equal(va, vb):
            raise AssertionError(f"{op}: column {c} differs")
    return err


class DeviceTimer:
    """Wraps each given kernel module's wrapper for one path's run: CUDA
    events around every call (device time of the kernel calls, sorts
    included); the first call's inputs (``inputs``) and those of the
    first call of each shape (:meth:`calls`) kept for the timing phases;
    and the host clock around the host's canonical record sort."""

    def __init__(self, mods):
        from repro_torch.core import accel
        self.mods = mods
        self.accel = accel
        self.events, self.inputs, self._orig = [], {}, {}
        self.shapes = {}
        self.sort_s = 0.0

    def __enter__(self):
        sort = self._sort = self.accel.canonical_order

        def timed_sort(*args):
            t0 = time.perf_counter()
            out = sort(*args)
            self.sort_s += time.perf_counter() - t0
            return out

        self.accel.canonical_order = timed_sort
        for mod in self.mods:
            name = mod.__name__.rsplit(".", 1)[1]
            fn = getattr(mod, name)
            self._orig[mod] = (name, fn)

            def wrapped(*args, _fn=fn, _name=name, **kw):
                if not args[0].is_cuda:        # the CPU path's plain run
                    return _fn(*args, **kw)
                self.inputs.setdefault(_name, (args, kw))
                sig = (_name,) + tuple(
                    tuple(a.shape) if isinstance(a, torch.Tensor) else a
                    for a in args) + tuple(sorted(kw.items()))
                self.shapes.setdefault(sig, (args, kw))
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = _fn(*args, **kw)
                t1.record()
                self.events.append((_name, t0, t1))
                return out

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        self.accel.canonical_order = self._sort
        for mod, (name, fn) in self._orig.items():
            setattr(mod, name, fn)

    def take_seconds(self):
        """(device seconds in kernel calls, host seconds in the canonical
        sort) since the last call."""
        torch.cuda.synchronize()
        s = sum(a.elapsed_time(b) for _n, a, b in self.events) / 1e3
        out = (s, self.sort_s)
        self.events, self.sort_s = [], 0.0
        return out

    def calls(self) -> dict:
        """{kernel: [(args, kw) of each call of another shape, in call
        order]}."""
        out = {}
        for sig, inputs in self.shapes.items():
            out.setdefault(sig[0], []).append(inputs)
        return out

    def seconds_by_kernel(self) -> dict:
        """Device seconds in each kernel's wrapper calls so far."""
        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.events:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) / 1e3
        return out


def run_ops(trace, label: str, timer=None) -> list:
    """Each op on the card and on the CPU path, within the gate; returns
    the card results' digests."""
    from repro_torch.launch.cardcheck import digest
    digests = []
    for op, kw in OPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = trace.run(op, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kern, sort = (timer.take_seconds() if timer is not None
                      else (float("nan"), float("nan")))
        t0 = time.perf_counter()
        on_cpu = trace.run(op, device="cpu", **kw)
        cpu_wall = time.perf_counter() - t0
        if timer is not None:
            timer.take_seconds()       # drop what the CPU path's run added
        err = same_result(op, on_card, on_cpu)
        digests.append(digest(on_card))
        log(f"[{label}] {op:17s} {json.dumps(kw, default=str):40s} "
            f"card wall {wall:.4f} s = kernels {kern:.4f} s + host "
            f"{wall - kern:.4f} s (canonical sort {sort:.4f} s) | cpu path "
            f"{cpu_wall:.3f} s | max_abs_err {err:.6g}")
    return digests


def phase_reader() -> None:
    from repro_torch import Trace
    from repro_torch.tracegen import big_trace
    out = os.path.join(ROOT, "build", "repro_torch", "smoke_trace")
    paths = big_trace(out, nprocs=4, events_per_proc=20_000, seed=1)
    t = Trace.open(paths, device="cuda")
    log(f"[reader] {len(t)} events from {len(paths)} jsonl shards")
    run_ops(t, "reader")


def reset_counts() -> None:
    """Every trace kernel's launch count, and its count by path, to 0."""
    from repro_torch import kernels
    for mod in kernels.TRACE_KERNELS:
        mod.LAUNCHES = 0
    for name in MAIN_PATHS:
        counts = getattr(kernels, name).PATH_LAUNCHES
        counts.update(dict.fromkeys(counts, 0))


def check_counts(label: str) -> dict:
    """The trace kernels' launch counts since :func:`reset_counts`: each
    kernel must have launched, and every call on its path
    (:data:`MAIN_PATHS`)."""
    from repro_torch import kernels
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in kernels.TRACE_KERNELS}
    paths = {name: dict(getattr(kernels, name).PATH_LAUNCHES)
             for name in MAIN_PATHS}
    log(f"[{label}] launches {json.dumps(launches)}; by path "
        f"{json.dumps(paths)}")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the {label} "
                             f"path: {idle}")
    off = [k for k, p in MAIN_PATHS.items() if paths[k][p] != launches[k]]
    if off:
        raise AssertionError(f"{label}-path calls off their path "
                             f"{MAIN_PATHS}: {off}")
    return launches


def phase_main():
    from repro_torch import Trace, kernels
    from repro_torch.tracegen import big_events
    t0 = time.perf_counter()
    ev = big_events(**MAIN)
    gen_s = time.perf_counter() - t0
    trace = Trace.from_events(ev, device="cuda")
    t0 = time.perf_counter()
    trace._ensure_structure()
    trace._ensure_messages()
    struct_s = time.perf_counter() - t0
    log(f"[main] {len(ev)} events, {trace.num_processes} ranks; "
        f"generate {gen_s:.2f} s, structure {struct_s:.2f} s (host)")
    reset_counts()
    with DeviceTimer(kernels.TRACE_KERNELS) as timer:
        digests = run_ops(trace, "main", timer)
    return trace, check_counts("main"), timer.calls(), digests


# ---------------------------------------------------------------------------
# phases 6-7: the lazy query and streaming routes
# ---------------------------------------------------------------------------

#: the query phase's plan: the one name of main-10M that
#: ``detectors.is_comm_name`` calls communication, then half the ranks
QUERY_DROP, QUERY_RANKS = "MpiSend", range(32)
#: a second selection that keeps the sends: the halo-exchange calls go,
#: their message instants stay, so the plan recomputes structure
HALO_DROP = "halo_exchange()"
#: the stream phase's trace: the port's ``big_trace`` jsonl shards
STREAM = dict(nprocs=64, events_per_proc=7_813, calls_per_iter=500,
              seed=0)
STREAM_CHUNK_ROWS = 65_536
#: a chunk size under one shard (about 7,400 rows), so that chunk
#: boundaries split enter/leave pairs and parent chains
SEAM_CHUNK_ROWS = 4_999
#: the stream phase holds the card against the CPU streaming route on one
#: op a kernel: seg_sum, time_bin, pair_sum (hist_bin's counts are exact:
#: the eager bits check them)
STREAM_CPU_OPS = [OPS[0], OPS[2], OPS[4]]


def _route(ops, run) -> list:
    """Each op through ``run(op, kw)`` on the card: [(result, wall s)]."""
    out = []
    for op, kw in ops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(op, kw)
        torch.cuda.synchronize()
        out.append((res, time.perf_counter() - t0))
    return out


def phase_query(trace) -> dict:
    """Plans over main-10M's in-memory trace on the card: each result the
    bits of the same selection made eagerly and reduced on the card."""
    from repro_torch.core import NAME, Filter
    from repro_torch.launch.cardcheck import digest

    def plan(q):
        return q.filter(Filter(NAME, "not-in", [QUERY_DROP])) \
            .restrict_processes(QUERY_RANKS)

    def halo(q):
        return q.filter(Filter(NAME, "not-in", [HALO_DROP]))

    halo_ops = [(op, kw) for op, kw in OPS
                if op in ("comm_matrix", "message_histogram")]
    reset_counts()
    lazy = [(plan, OPS, _route(
        OPS, lambda op, kw: plan(trace.query()).run(op, **kw)))]
    lazy.append((halo, halo_ops, _route(
        halo_ops, lambda op, kw: halo(trace.query()).run(op, **kw))))
    launches = check_counts("query")
    for sel, ops, results in lazy:
        t0 = time.perf_counter()
        sub = sel(trace.query()).collect()
        collect_s = time.perf_counter() - t0
        if sub.device != trace.device:
            raise AssertionError(f"selection moved to {sub.device}")
        log(f"[query] eager selection {len(sub)} of {len(trace)} events "
            f"in {collect_s:.2f} s, structure "
            f"{'remapped' if sub._structured else 'dropped (recompute)'}")
        for (op, kw), (res, wall) in zip(ops, results):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = sub.run(op, **kw)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            same = digest(res) == digest(want)
            log(f"[query] {op:17s} {json.dumps(kw, default=str):34s} "
                f"plan {wall:.3f} s | eager {eager_s:.3f} s (+ selection) "
                f"| bits {'equal' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"query {op}: the plan's result is "
                                     f"not the eager selection's bits")
    # the card against the CPU path: stragglers over the whole trace, and
    # the first plan
    for label, op, run in (
            ("whole trace", "stragglers", lambda d: trace.run(
                "stragglers", threshold=-1.0, device=d)),
            ("plan", OPS[0][0], lambda d: plan(trace.query()).run(
                OPS[0][0], device=d, **OPS[0][1]))):
        t0 = time.perf_counter()
        on_card = run("cuda")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = run("cpu")
        cpu_s = time.perf_counter() - t0
        err = same_result(op, on_card, on_cpu)
        log(f"[query] {op} on the {label}: card {card_s:.3f} s, cpu path "
            f"{cpu_s:.3f} s, max_abs_err {err:.6g}")
    return launches


def phase_stream():
    """``Trace.open(..., streaming=True)`` over jsonl shards on the card:
    each op the bits of ``Trace.open(paths)`` on the card, and within the
    gate of the CPU streaming route.  Returns the launches, the eager
    results' digests and the eager trace (stream-0.5M in memory)."""
    import tempfile

    from repro_torch import Trace
    from repro_torch.launch.cardcheck import digest
    from repro_torch.tracegen import big_trace
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = big_trace(d, **STREAM)
        write_s = time.perf_counter() - t0
        st = Trace.open(paths, streaming=True, chunk_rows=STREAM_CHUNK_ROWS,
                        device="cuda")
        reset_counts()
        streamed = _route(OPS, lambda op, kw: st.run(op, **kw))
        launches = check_counts("stream")
        t0 = time.perf_counter()
        eager = Trace.open(paths, device="cuda")
        eager._ensure_structure()
        eager._ensure_messages()
        open_s = time.perf_counter() - t0
        log(f"[stream] {len(eager)} events in {len(paths)} jsonl shards: "
            f"written in {write_s:.2f} s; eager open + structure "
            f"{open_s:.2f} s; chunks of {STREAM_CHUNK_ROWS} rows")
        wants = []
        for (op, kw), (res, wall) in zip(OPS, streamed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = eager.run(op, **kw)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            wants.append(digest(want))
            same = digest(res) == digest(want)
            cpu = "cpu streaming not run"
            if (op, kw) in STREAM_CPU_OPS:
                t0 = time.perf_counter()
                on_cpu = st.run(op, device="cpu", **kw)
                cpu_s = time.perf_counter() - t0
                err = same_result(op, res, on_cpu)
                cpu = f"cpu streaming {cpu_s:.3f} s, max_abs_err {err:.6g}"
            log(f"[stream] {op:17s} {json.dumps(kw, default=str):34s} "
                f"streaming {wall:.3f} s | eager {eager_s:.3f} s | bits "
                f"{'equal' if same else 'DIFFER'} | {cpu}")
            if not same:
                raise AssertionError(f"stream {op}: not the eager bits")
        seams = Trace.open(paths, streaming=True, chunk_rows=SEAM_CHUNK_ROWS,
                           device="cuda")
        for op, kw in OPS[:1]:
            t0 = time.perf_counter()
            same = digest(seams.run(op, **kw)) == digest(eager.run(op, **kw))
            log(f"[stream] {op:17s} {json.dumps(kw, default=str):34s} "
                f"chunks of {SEAM_CHUNK_ROWS} rows "
                f"{time.perf_counter() - t0:.3f} s | bits "
                f"{'equal' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"stream {op} at {SEAM_CHUNK_ROWS} "
                                     f"rows a chunk: not the eager bits")
    return launches, wants, eager


# ---------------------------------------------------------------------------
# phases 8-9: the pack and parallel work-unit routes
# ---------------------------------------------------------------------------

#: the pack phase's shards: main-10M's events as 64 ``rank_<p>.pack``
#: files with structure sidecars
PACK = dict(MAIN, calls_per_iter=500, format="pack")
#: bytes a main-10M event takes in a pack: event columns (ts i8, et i1,
#: name / proc i4, size f8, partner / tag i4) and sidecar (matching i8,
#: depth i4, parent i8, inc f8, exc f8)
PACK_BYTES_PER_EVENT = 37 + 36
#: the corruption check re-packs one shard in groups of this many rows
DAMAGE_GROUP_ROWS = 16_384
#: the scan check's plan: the first 8 of 64 ranks
SCAN_RANKS = range(8)


def _worker_ready(_):
    """Run in each spawn worker: import the port, report whether CUDA was
    initialized there (it never should be)."""
    import repro_torch.core.executor  # noqa: F401
    return torch.cuda.is_initialized()


def start_pool():
    """The shared scheduler's spawn pool of ``min(os.cpu_count(), 8)``
    workers for the pooled routes (a set opened with that many processes
    fans into the same pool), warmed up: (pool, workers, start-up
    seconds)."""
    from repro_torch.core.scheduler import get_scheduler
    workers = min(os.cpu_count() or 1, 8)
    t0 = time.perf_counter()
    pool = get_scheduler().spawn_pool(workers)
    ready = pool.map(_worker_ready, range(4 * workers))
    start_s = time.perf_counter() - t0
    if any(ready):
        raise AssertionError("a pool worker initialized CUDA on start-up")
    log(f"[pool] {workers} spawn workers (os.cpu_count() = "
        f"{os.cpu_count()}) started and warm in {start_s:.2f} s "
        f"(each imports torch and the port) | {SMI[0]}")
    return pool, workers, start_s


#: (phase, route) -> each op's wall in :func:`_route_bits`, for the fold
#: phase's lines beside the buffered route's
ROUTE_WALLS = {}


def _route_bits(label, route, ops, run, wants, n_events, expect,
                pooled=None) -> list:
    """``run(op, kw)`` for each op on the card, counts reset before and
    read after: each result the bits of ``wants``, every kernel launched
    ``expect`` times on its path; per-op wall and events/s logged.  For
    a ``pooled`` handle, each op must have run over 2 or more units, none
    of which initialized CUDA.  Returns (results, launches)."""
    import warnings

    from repro_torch.launch.cardcheck import digest

    def pooled_run(op, kw):
        pooled.units_cuda = []
        res = run(op, kw)
        if len(pooled.units_cuda) < 2 or any(pooled.units_cuda):
            raise AssertionError(f"{label} {route} {op}: the units' "
                                 f"torch.cuda.is_initialized() "
                                 f"{pooled.units_cuda}")
        return res

    reset_counts()
    with warnings.catch_warnings():
        # a run that fell back to serial cannot pass as a parallel one
        warnings.filterwarnings("error", message="parallel streaming",
                                category=RuntimeWarning)
        results = _route(ops, run if pooled is None else pooled_run)
    launches = expect_counts(f"{label} {route}", expect)
    ROUTE_WALLS[label, route] = [wall for _r, wall in results]
    for (op, kw), (res, wall), want in zip(ops, results, wants):
        same = digest(res) == want
        log(f"[{label}] {route:16s} {op:17s} "
            f"{json.dumps(kw, default=str):34s} wall {wall:.3f} s, "
            f"{n_events / wall:,.0f} events/s | bits "
            f"{'equal' if same else 'DIFFER'} | {SMI[0]}")
        if not same:
            raise AssertionError(f"{label} {route} {op}: not the eager "
                                 f"bits")
    return [r for r, _w in results], launches


def phase_pack(main_digests, main_launches, pool, workers, d,
               kept) -> dict:
    """main-10M as 64 pack shards in ``d``/pack (left there for the fold
    and served phases): the eager, serial-streamed and pooled routes give
    phase 5's bits, ``scan`` skips the shards its plan excludes, and a
    damaged shard is refused, dropped and salvaged.  The eager results and
    the shards go to ``kept`` (for the fold phase).  Returns each route's
    launches."""
    import shutil

    from repro_torch import Trace
    from repro_torch.core import PROC, Filter, structure
    from repro_torch.core.query import scan
    from repro_torch.launch.cardcheck import digest
    from repro_torch.readers import pack, parallel
    from repro_torch.tracegen import big_trace
    n_events = MAIN["nprocs"] * MAIN["events_per_proc"]  # about; exact below
    need = n_events * PACK_BYTES_PER_EVENT
    free = shutil.disk_usage(d).free
    log(f"[pack] {d}: {free / 1e9:.2f} GB free, the shards need about "
        f"{need / 1e9:.2f} GB")
    if free < 1.5 * need:
        raise RuntimeError(f"pack phase: {free / 1e9:.2f} GB free in "
                           f"{d}, need about {1.5 * need / 1e9:.2f} GB")
    t0 = time.perf_counter()
    shards = big_trace(os.path.join(d, "pack"), **PACK)
    write_s = time.perf_counter() - t0
    size = sum(os.path.getsize(p) for p in shards)
    n_events = sum(pack.read_footer(p)["rows"] for p in shards)
    log(f"[pack] wrote {len(shards)} shards, {n_events} events, "
        f"{size / 1e6:.1f} MB with sidecars, in {write_s:.2f} s | "
        f"{SMI[0]}")

    # eager: the open, then the seven op calls.  Merging the shards
    # renumbers their rows, so the sidecars are dropped and the first
    # op derives structure, once
    derive0 = structure.DERIVE_CALLS
    t0 = time.perf_counter()
    eager = Trace.open(shards, device="cuda")
    open_s = time.perf_counter() - t0
    if len(eager) != n_events:
        raise AssertionError(f"pack open: {len(eager)} events")
    log(f"[pack] eager open of {len(shards)} shards: {len(eager)} "
        f"events in {open_s:.2f} s, {len(eager) / open_s:,.0f} "
        f"events/s | {SMI[0]}")
    launches = {}
    kept["eager"], launches["pack eager"] = _route_bits(
        "pack", "eager", OPS, lambda op, kw: eager.run(op, **kw),
        main_digests, n_events, main_launches)
    kept["shards"] = shards
    derived = structure.DERIVE_CALLS - derive0
    if derived != 1:
        raise AssertionError(f"the eager sharded pack route derived "
                             f"structure {derived} times, not once")
    # one shard opened alone: its sidecar is its structure
    derive0 = structure.DERIVE_CALLS
    t0 = time.perf_counter()
    one = Trace.open(shards[0], device="cuda")
    one.flat_profile()
    one_s = time.perf_counter() - t0
    if structure.DERIVE_CALLS != derive0:
        raise AssertionError("a single pack shard with its sidecar "
                             "derived structure")
    log(f"[pack] eager route: structure derived once, at the first op; "
        f"one shard ({len(one)} events) opened alone with its sidecar "
        f"and profiled in {one_s:.3f} s, no structure derived | "
        f"{SMI[0]}")
    del one

    # the scan: 8 of 64 shards read, the eager selection's bits
    sel = Filter(PROC, "in", list(SCAN_RANKS))
    kept = parallel.select_shards(shards, procs=set(SCAN_RANKS))
    t0 = time.perf_counter()
    q = scan(shards).filter(sel)
    got = q.flat_profile()
    scan_s = time.perf_counter() - t0
    sub = q.collect()
    want = eager.query().filter(sel).collect().flat_profile()
    same = digest(got) == digest(want)
    log(f"[pack] scan(...).filter(Process in 0..7).flat_profile(): "
        f"{scan_s:.3f} s, {len(shards) - len(kept)} of {len(shards)} "
        f"shards skipped unread (read: {sub.label}) | bits "
        f"{'equal' if same else 'DIFFER'} | {SMI[0]}")
    if not same or len(kept) != len(SCAN_RANKS) or \
            sub.label != f"parallel[{len(SCAN_RANKS)}]":
        raise AssertionError("scan: wrong bits or shards")
    del eager, sub

    # streamed, serial then pooled: sidecar slices, no derivation
    st = Trace.open(shards, streaming=True, device="cuda")
    derive0 = structure.DERIVE_CALLS
    _res, launches["pack streamed"] = _route_bits(
        "pack", "streamed", OPS, lambda op, kw: st.run(op, **kw),
        main_digests, n_events, main_launches)
    if structure.DERIVE_CALLS != derive0:
        raise AssertionError("the streamed pack route derived "
                             "structure")
    pst = Trace.open(shards, streaming=True, device="cuda",
                     processes=workers)
    pst._pool = pool
    _res, launches["pack pooled"] = _route_bits(
        "pack", f"pooled x{workers}", OPS,
        lambda op, kw: pst.run(op, **kw), main_digests, n_events,
        main_launches, pooled=pst)

    # corruption: one shard re-packed in groups, one byte flipped
    good = os.path.join(d, "groups.pack")
    Trace.open(shards[0], device="cpu").save_pack(
        good, chunk_rows=DAMAGE_GROUP_ROWS)
    _damage_check(pack, good, d)
    return launches


def _damage_check(pack, good, d) -> None:
    """A flipped byte in an interior group: ``verify_pack`` names it,
    ``skip_chunk`` drops exactly its rows, the file with its footer torn
    off is refused under ``strict`` and ``salvage`` recovers every other
    group byte for byte."""
    import warnings

    from repro_torch.core.constants import NAME, PROC, TS
    chunks = pack.read_footer(good)["chunks"]
    victim = chunks[len(chunks) // 2]
    with open(good, "rb") as f:
        raw = bytearray(f.read())
    raw[victim["offset"] + 7] ^= 0x10
    flip, torn = os.path.join(d, "flip.pack"), os.path.join(d, "torn.pack")
    with open(flip, "wb") as f:
        f.write(raw)
    end = max(c["offset"] + c["nbytes"] + c["tlen"] + 16 for c in chunks)
    with open(torn, "wb") as f:
        f.write(raw[:end + 5])
    rep = pack.verify_pack(flip)
    bad = [g["offset"] for g in rep["chunks_bad"]]
    if bad != [victim["offset"]]:
        raise AssertionError(f"verify_pack: bad groups {bad}")
    whole = pack.read_pack(good, device="cpu").events
    keep = np.ones(len(whole), bool)
    keep[victim["lo"]:victim["hi"]] = False
    try:
        pack.read_pack(torn, device="cpu")
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("strict opened a pack with a torn footer")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        dropped = pack.read_pack(flip, on_error="skip_chunk",
                                 device="cpu").events
        salvaged = pack.read_pack(torn, on_error="salvage",
                                  device="cpu").events
    for label, ev in (("skip_chunk", dropped), ("salvage", salvaged)):
        for c in (TS, PROC):
            if not np.array_equal(np.asarray(ev[c]),
                                  np.asarray(whole[c])[keep]):
                raise AssertionError(f"{label}: column {c} differs")
        if not np.array_equal(ev[NAME], whole[NAME][keep]):
            raise AssertionError(f"{label}: names differ")
    log(f"[pack] damage: {len(chunks)} groups of {DAMAGE_GROUP_ROWS} rows, "
        f"one byte flipped in group {chunks.index(victim)}: verify_pack "
        f"names it; strict refuses the torn file ({refused[:60]}...); "
        f"skip_chunk keeps {len(dropped)} rows and salvage {len(salvaged)}"
        f" of {len(whole)}, every clean group byte for byte")


#: the kernel each op's fold launches once a chunk (``diagnose`` through
#: ``stragglers``' fold); the host folds launch none
FOLD_KERNEL = {"flat_profile": "seg_sum", "time_profile": "time_bin",
               "load_imbalance": "pair_sum", "comm_matrix": "pair_sum",
               "message_histogram": "hist_bin", "stragglers": "seg_sum",
               "diagnose": "seg_sum", "regression_report": "seg_sum"}
#: the fold phase's memory check: the first 8 shards opened alone, then
#: all 64, under ``tracemalloc``; the op it runs
FOLD_FEW_SHARDS = 8
FOLD_MEMORY_OP = OPS[0]
#: the host ops, the five other detectors and ``diagnose`` with
#: ``fold="chunks"`` (phase 14b), each with its default arguments, as
#: ``diagnose`` runs the detectors
HOST_FOLD_OPS = [("idle_time", {}), ("comm_by_process", {}),
                 ("late_sender", {}), ("serialization", {}),
                 ("imbalance_root_cause", {}), ("efficiency_metrics", {}),
                 ("pop_efficiency", {}), ("diagnose", {})]
#: the two of them whose traced host peak phase 14b measures
HOST_FOLD_MEMORY_OPS = [HOST_FOLD_OPS[5], HOST_FOLD_OPS[7]]
#: main-10M's eager results that phase 14b holds the folds against:
#: ``diagnose`` (phase 13), ``idle_time`` and ``comm_by_process``
#: (phase 14); and pack-10M's fold results (phase 14b) that phase 16's
#: service must give
MAIN_RESULTS = {}
FOLD_RESULTS = {}


def _fold_kernel(op, kw):
    """The kernel ``op``'s fold launches once a chunk, or None."""
    return "pair_sum" if kw.get("per_process") else FOLD_KERNEL.get(op)


def _counted_fold(run, label, op, kw, chunks) -> tuple:
    """``run()`` with the trace kernels' counts and
    ``streaming.FOLDED_CHUNKS`` reset just before: (result, wall s,
    launches).  A kernel-backed fold launches its kernel once a folded
    chunk, on its path, and folds every one of ``chunks``; a host fold
    launches nothing and folds none."""
    from repro_torch import kernels
    from repro_torch.core import streaming
    reset_counts()
    streaming.FOLDED_CHUNKS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect = {mod.__name__.rsplit(".", 1)[1]: 0
              for mod in kernels.TRACE_KERNELS}
    kernel = _fold_kernel(op, kw)
    if kernel is not None:
        expect[kernel] = streaming.FOLDED_CHUNKS
    got = expect_counts(f"fold {label} {op}", expect)
    want = chunks if kernel is not None else 0
    if streaming.FOLDED_CHUNKS != want:
        raise AssertionError(f"fold {label} {op}: "
                             f"{streaming.FOLDED_CHUNKS} chunks folded, "
                             f"{want} expected")
    return res, wall, got


def _traced_peak(run) -> tuple:
    """(``run()``'s result, wall s, peak bytes ``tracemalloc`` traced while
    it ran): NumPy's allocations are traced, pages mapped from a file and
    torch's own allocations are not."""
    import gc
    import tracemalloc
    gc.collect()
    tracemalloc.start()
    try:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, wall, tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def _pack_chunks(shards) -> int:
    """Chunks of ``streaming.DEFAULT_CHUNK_ROWS`` rows in the pack
    shards: one a shard at pack-10M."""
    from repro_torch.core import streaming
    from repro_torch.readers import pack
    return sum(-(-pack.read_footer(p)["rows"] // streaming.DEFAULT_CHUNK_ROWS)
               for p in shards)


def phase_fold(shards, eager, pool, workers) -> dict:
    """pack-10M's 64 shards streamed with ``fold="chunks"``: the seven op
    calls each within the gate of the eager route (phase 8's results),
    counts and edges exact, one launch of the op's kernel for each chunk
    that held records, the same bits on a second call, the wall beside
    the buffered streamed route's; ``flat_profile``'s traced host peak on
    the fold and buffered routes over 8 shards and 64; then the seven over
    the pool, each within the gate of the serial fold, no unit on the
    card.  Returns the routes' launches."""
    import warnings

    from repro_torch import Trace
    from repro_torch.launch.cardcheck import digest, op_gate
    chunks = _pack_chunks(shards)
    buffered = ROUTE_WALLS["pack", "streamed"]

    def counted(run, label, op, kw):
        """``run()`` with the counts reset before: (result, wall s); its
        launches are one of the op's kernel a folded chunk, on its path,
        and every chunk folded."""
        res, wall, got = _counted_fold(run, label, op, kw, chunks)
        totals[label] = {k: totals[label].get(k, 0) + v
                         for k, v in got.items()}
        return res, wall

    totals = {"serial": {}, "pooled": {}}
    st = Trace.open(shards, streaming=True, device="cuda", fold="chunks")
    serial = []
    for (op, kw), want, buf_s in zip(OPS, eager, buffered):
        res, wall = counted(lambda: st.run(op, **kw), "serial", op, kw)
        err = op_gate(op, res, want)
        t0 = time.perf_counter()
        same = digest(st.run(op, **kw)) == digest(res)
        again_s = time.perf_counter() - t0
        log(f"[fold] {op:17s} {json.dumps(kw, default=str):34s} "
            f"wall {wall:.3f} s (again {again_s:.3f} s, bits "
            f"{'equal' if same else 'DIFFER'}) | buffered streamed "
            f"{buf_s:.3f} s | {_fold_kernel(op, kw)} x {chunks} | within "
            f"the gate of eager, max_abs_err {err:.6g} | {SMI[0]}")
        if not same:
            raise AssertionError(f"fold {op}: other bits on relaunch")
        serial.append(res)

    op, kw = FOLD_MEMORY_OP
    peaks = {}
    for n in (FOLD_FEW_SHARDS, len(shards)):
        for fold in ("chunks", "once"):
            h = Trace.open(shards[:n], streaming=True, device="cuda",
                           fold=fold)
            _res, wall, peaks[n, fold] = _traced_peak(
                lambda: h.run(op, **kw))
            log(f"[fold] memory {op} {json.dumps(kw, default=str)} over "
                f"{n} shards, fold={fold!r}: traced host peak "
                f"{peaks[n, fold] / 2**20:.1f} MiB (tracemalloc: NumPy's "
                f"allocations; mapped pack pages not counted), wall "
                f"{wall:.3f} s under tracing")
    many, few = len(shards), FOLD_FEW_SHARDS
    ratio = peaks[many, "once"] / peaks[many, "chunks"]
    growth = peaks[many, "chunks"] / peaks[few, "chunks"]
    log(f"[fold] memory: at {many} shards the buffered peak is {ratio:.2f}x "
        f"the fold's; the fold's peak at {many} shards is {growth:.2f}x its "
        f"peak at {few}")
    if ratio < 2 or growth > 1.5:
        raise AssertionError(f"fold memory: buffered/fold {ratio:.2f} "
                             f"(needs >= 2), fold {many}/{few} shards "
                             f"{growth:.2f} (needs <= 1.5)")

    pst = Trace.open(shards, streaming=True, device="cuda", fold="chunks",
                     processes=workers)
    pst._pool = pool
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="parallel streaming",
                                category=RuntimeWarning)
        for (op, kw), want in zip(OPS, serial):
            res, wall = counted(lambda: pst.run(op, **kw), "pooled", op, kw)
            err = op_gate(op, res, want)
            log(f"[fold] pooled x{workers} {op:17s} "
                f"{json.dumps(kw, default=str):34s} wall {wall:.3f} s | "
                f"within the gate of the serial fold, max_abs_err "
                f"{err:.6g} | units' torch.cuda.is_initialized() "
                f"{sorted(set(pst.units_cuda))} over "
                f"{len(pst.units_cuda)} units | {SMI[0]}")
            if len(pst.units_cuda) < 2 or any(pst.units_cuda):
                raise AssertionError(f"fold pooled {op}: units "
                                     f"{pst.units_cuda}")
    return {"pack fold": totals["serial"],
            f"pack fold x{workers}": totals["pooled"]}


def _detector_rows(findings, name: str):
    """The rows of a ``diagnose`` Findings frame that detector ``name``
    gave (what the detector alone returns with its default arguments)."""
    return findings.take(np.nonzero(np.asarray(findings["detector"])
                                    == name)[0])


def _main_result(trace, op) -> tuple:
    """(main-10M's eager result of ``op`` with its default arguments on
    the card, where it came from): phase 13's ``diagnose`` (a detector's
    own rows of it) or phase 14's call where the run made one, else one
    call now."""
    from repro_torch.core.detectors import list_detectors
    if op in list_detectors():
        res, came = _main_result(trace, "diagnose")
        return _detector_rows(res, op), f"diagnose's rows, {came}"
    if op in MAIN_RESULTS:
        return MAIN_RESULTS[op], "reused"
    t0 = time.perf_counter()
    MAIN_RESULTS[op] = trace.run(op)
    return MAIN_RESULTS[op], f"{time.perf_counter() - t0:.3f} s"


def phase_fold_hosts(trace, shards, pool, workers) -> dict:
    """pack-10M's 64 shards streamed with ``fold="chunks"`` for the host
    ops, the five other detectors and ``diagnose``
    (:data:`HOST_FOLD_OPS`): each the bits of main-10M's eager result (a
    Findings frame by ``findings_gate``: the host detectors' rows exact,
    ``stragglers``' severities within the gate), no launch, no chunk
    folded, but ``diagnose``'s ``seg_sum`` once a chunk (and its same bits
    on a second call); ``efficiency_metrics``' and ``diagnose``'s traced
    host peaks on the fold and buffered routes over 8 shards and 64; then
    the eight over the pool, each within the gate of the serial fold, no
    unit on the card.  Returns the routes' launches."""
    import warnings

    from repro_torch import Trace
    from repro_torch.launch.cardcheck import digest, op_gate
    chunks = _pack_chunks(shards)
    totals = {"serial": {}, "pooled": {}}

    def counted(run, label, op, kw):
        res, wall, got = _counted_fold(run, label, op, kw, chunks)
        totals[label] = {k: totals[label].get(k, 0) + v
                         for k, v in got.items()}
        return res, wall

    st = Trace.open(shards, streaming=True, device="cuda", fold="chunks")
    peaks = {}
    for op, kw in HOST_FOLD_OPS:
        want, came = _main_result(trace, op)
        res, wall = counted(lambda: st.run(op, **kw), "serial", op, kw)
        err = op_gate(op, res, want)
        kernel = _fold_kernel(op, kw)
        if "detector" in res.columns and kernel is None:
            # findings_gate held every field of a host detector's rows
            same, check = True, "eager findings equal"
        elif kernel is None:
            # integer-ns sums on the host: the eager bits
            same = digest(res) == digest(want)
            check = f"eager bits {'equal' if same else 'DIFFER'}"
        else:
            # the second call is the memory check's fold at all shards
            again, again_s, peaks[op, len(shards), "chunks"] = \
                _traced_peak(lambda: st.run(op, **kw))
            same = digest(again) == digest(res)
            check = (f"within the gate of eager, max_abs_err {err:.6g}; "
                     f"again {again_s:.3f} s under tracing, bits "
                     f"{'equal' if same else 'DIFFER'}")
        log(f"[fold] {op:20s} wall {wall:.3f} s | "
            f"{f'{kernel} x {chunks}' if kernel else 'no launch'} | "
            f"{check} | eager {came} | {len(res)} rows | {SMI[0]}")
        if not same:
            raise AssertionError(f"fold {op}: not the eager bits, or "
                                 f"other bits on relaunch")
        FOLD_RESULTS[op] = res

    for op, kw in HOST_FOLD_MEMORY_OPS:
        for n in (FOLD_FEW_SHARDS, len(shards)):
            for fold in ("chunks", "once"):
                if (op, n, fold) in peaks:
                    how = "the serial fold's second call"
                else:
                    h = Trace.open(shards[:n], streaming=True,
                                   device="cuda", fold=fold)
                    _res, wall, peaks[op, n, fold] = _traced_peak(
                        lambda: h.run(op, **kw))
                    how = f"wall {wall:.3f} s under tracing"
                log(f"[fold] memory {op} over {n} shards, fold={fold!r}: "
                    f"traced host peak "
                    f"{peaks[op, n, fold] / 2**20:.1f} MiB (tracemalloc: "
                    f"NumPy's allocations; mapped pack pages not counted), "
                    f"{how}")
        many, few = len(shards), FOLD_FEW_SHARDS
        ratio = peaks[op, many, "once"] / peaks[op, many, "chunks"]
        growth = peaks[op, many, "chunks"] / peaks[op, few, "chunks"]
        log(f"[fold] memory {op}: at {many} shards the buffered peak is "
            f"{ratio:.2f}x the fold's; the fold's peak at {many} shards is "
            f"{growth:.2f}x its peak at {few}")
        if op == "diagnose":
            # late_sender's message instants grow with the trace, as the
            # reference's do: the fold need only sit below the buffered
            # route
            if ratio <= 1:
                raise AssertionError(f"fold memory {op}: buffered/fold "
                                     f"{ratio:.2f} (needs > 1)")
        elif ratio < 2 or growth > 1.5:
            raise AssertionError(f"fold memory {op}: buffered/fold "
                                 f"{ratio:.2f} (needs >= 2), fold "
                                 f"{many}/{few} shards {growth:.2f} "
                                 f"(needs <= 1.5)")

    pst = Trace.open(shards, streaming=True, device="cuda", fold="chunks",
                     processes=workers)
    pst._pool = pool
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="parallel streaming",
                                category=RuntimeWarning)
        for op, kw in HOST_FOLD_OPS:
            res, wall = counted(lambda: pst.run(op, **kw), "pooled", op, kw)
            err = op_gate(op, res, FOLD_RESULTS[op])
            log(f"[fold] pooled x{workers} {op:20s} wall {wall:.3f} s | "
                f"within the gate of the serial fold, max_abs_err "
                f"{err:.6g} | units' torch.cuda.is_initialized() "
                f"{sorted(set(pst.units_cuda))} over "
                f"{len(pst.units_cuda)} units | {SMI[0]}")
            if len(pst.units_cuda) < 2 or any(pst.units_cuda):
                raise AssertionError(f"fold pooled {op}: units "
                                     f"{pst.units_cuda}")
    return {"pack fold hosts": totals["serial"],
            f"pack fold hosts x{workers}": totals["pooled"]}


# ---------------------------------------------------------------------------
# phase 14c: the reference's extension surface
# ---------------------------------------------------------------------------

#: what :func:`register_extensions` registers, removed at phase 14c's end
EXT_OPS = ("busiest_function", "my_analysis", "gpu_idle",
           "iteration_count_delta", "enter_counts")
EXT_READER = "myfmt"


def _myfmt_columns(path):
    """A ``.myfmt`` file (an ``.npz`` of a frame's columns, a categorical
    one with its category table) as [(name, values, categories or None)]."""
    with np.load(path, allow_pickle=False) as z:
        return [(str(n), z[f"v{i}"], z[f"c{i}"] if f"c{i}" in z.files
                 else None) for i, n in enumerate(z["columns"])]


def _rows(frame) -> dict:
    """A frame's columns as lists (an empty frame's, whatever its dtypes,
    compare equal)."""
    return {c: np.asarray(frame[c]).tolist() for c in frame.columns}


def write_myfmt(frame, path) -> str:
    arrays = {"columns": np.asarray(frame.columns)}
    for i, c in enumerate(frame.columns):
        col = frame.column(c)
        if hasattr(col, "codes"):
            arrays[f"v{i}"] = np.asarray(col.codes)
            arrays[f"c{i}"] = np.asarray(col.categories).astype(str)
        else:
            arrays[f"v{i}"] = np.asarray(col)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def register_extensions() -> None:
    """The reference's documented extension examples, registered in the
    port as its users write them (``fn(trace, **kwargs)``, no ``device``
    parameter anywhere): ``busiest_function`` (``examples/quickstart.py``),
    ``my_analysis`` (``docs/api.md``), the ``gpu_idle`` detector
    (``docs/diagnostics.md``), the ``iteration_count_delta`` set op
    (``docs/comparing-traces.md``), a ``.myfmt`` reader with
    ``iter_chunks=`` and ``enter_counts`` with a streaming aggregator
    (``docs/streaming.md``)."""
    from repro_torch.core import (Categorical, EventFrame, Findings, Trace,
                                  register_detector, register_op,
                                  register_reader, register_streaming)
    from repro_torch.core.constants import ENTER, ET, EXC, INC, NAME, PROC, TS
    from repro_torch.core.streaming import StreamAgg

    @register_op("busiest_function", needs_structure=True)
    def busiest_function(trace, metric=EXC):
        """Name of the function with the largest total exclusive time."""
        ev = trace.events
        ent = ev.mask(ev.cat(ET).mask_eq(ENTER))
        prof = ent.groupby_agg(NAME, {metric: "sum"})
        vals = np.nan_to_num(np.asarray(prof[metric], np.float64))
        return str(prof[NAME][int(np.argmax(vals))])

    @register_op("my_analysis", needs_structure=True)
    def my_analysis(trace, **kwargs):
        """Calls and longest inclusive time of the most-called functions."""
        ev = trace.events
        ent = ev.mask(ev.cat(ET).mask_eq(ENTER))
        prof = ent.groupby_agg(NAME, {INC: "max"}, count_name="calls")
        rows = sorted(zip(np.asarray(prof[NAME]).astype(str).tolist(),
                          np.asarray(prof["calls"]).tolist(),
                          np.asarray(prof[INC], np.float64).tolist()),
                      key=lambda r: (-r[1], r[0]))
        return rows[:kwargs.get("top", 3)]

    @register_detector("gpu_idle", category="efficiency", threshold=0.25)
    def gpu_idle(trace, threshold=0.25):
        """Flags ranks whose idle share exceeds the threshold."""
        ev = trace.events
        ts = np.asarray(ev[TS], np.float64)
        procs = np.asarray(ev[PROC], np.int64)
        idle = trace.idle_time()
        rows = []
        for rank, spent in zip(np.asarray(idle[PROC]).tolist(),
                               np.asarray(idle["idle_time"]).tolist()):
            on = ts[procs == rank]
            t0, t1 = float(on.min()), float(on.max())
            frac = spent / (t1 - t0) if t1 > t0 else 0.0
            if frac >= threshold:
                rows.append({
                    "detector": "gpu_idle", "location": f"rank {rank}",
                    "process": rank, "function": "", "severity": frac,
                    "t_start": t0, "t_end": t1,
                    "explanation": f"rank {rank} idle {frac:.0%} of the run",
                })
        return Findings(rows)

    @register_op("iteration_count_delta", needs_structure=True, scope="set")
    def iteration_count_delta(traces, marker="time-loop"):
        """Change in detected iteration count between first and last run."""
        def count(t):
            ev = t.events
            m = ev.cat("Name").mask_eq(marker) & \
                ev.cat("Event Type").mask_eq("Enter")
            return int(np.count_nonzero(m))
        return count(traces[-1]) - count(traces[0])

    def load_frame(path):
        frame = EventFrame()
        for name, vals, cats in _myfmt_columns(path):
            frame[name] = vals if cats is None else Categorical(vals, cats)
        return frame

    def read_myfmt(path, label=None):
        return Trace(load_frame(path), label=label or path)

    def iter_myfmt(path, chunk_rows, hints=None, **kw):
        ev = load_frame(path)
        for lo in range(0, len(ev), chunk_rows):
            yield ev.take(np.arange(lo, min(lo + chunk_rows, len(ev))))

    register_reader(EXT_READER, extensions=(".myfmt",),
                    iter_chunks=iter_myfmt)(read_myfmt)

    @register_op("enter_counts")
    def enter_counts(trace):
        """Enter events by function name."""
        ev = trace.events
        keys, counts = np.unique(np.asarray(
            ev[NAME][ev.cat(ET).mask_eq(ENTER)]).astype(str),
            return_counts=True)
        return dict(zip(keys.tolist(), counts.tolist()))

    @register_streaming("enter_counts")
    class EnterCounts(StreamAgg):
        supports_parallel = True

        def __init__(self):
            self.counts = np.zeros(0, np.int64)

        def _grow(self, n):
            if n > len(self.counts):
                self.counts = np.concatenate(
                    [self.counts, np.zeros(n - len(self.counts), np.int64)])

        def update(self, chunk):
            codes = np.asarray(chunk.gcodes)[
                chunk.events.cat(ET).mask_eq(ENTER)]
            if codes.size:
                self._grow(int(codes.max()) + 1)
                np.add.at(self.counts, codes, 1)

        def merge_from(self, other, code_map):
            if len(other.counts):
                mapped = np.asarray(code_map)[:len(other.counts)]
                self._grow(int(mapped.max()) + 1)
                np.add.at(self.counts, mapped, other.counts)

        def result(self, ctx):
            names = ctx.names.names
            return dict(sorted((names[i], int(c))
                               for i, c in enumerate(self.counts) if c))


def unregister_extensions() -> None:
    from repro_torch.core import detectors, registry
    for name in EXT_OPS:
        registry._OP_REGISTRY.pop(name, None)
    detectors._DETECTOR_REGISTRY.pop("gpu_idle", None)
    registry._READER_REGISTRY.pop(EXT_READER, None)


def phase_extensions(trace, stream_paths, d) -> dict:
    """Phase 14c: the examples of :func:`register_extensions` on the card.
    ``diagnose()`` on main-10M with ``gpu_idle`` registered: phase 13's
    findings unchanged plus ``gpu_idle``'s own call, one ``seg_sum``
    launch as without it; ``busiest_function`` and ``my_analysis`` (host
    ``groupby_agg``, no launch), the first against the card's
    ``flat_profile``; the set op on two baselines; stream-0.5M's 64 jsonl
    shards as ``.myfmt`` files: opened eagerly the trace is on the card,
    and a ``fold="chunks"`` ``flat_profile`` over the user reader's
    ``iter_chunks`` gives the jsonl reader's bits with the same launches;
    ``enter_counts`` streamed over them the counts read off the files.
    Returns the launches."""
    from repro_torch import Trace, TraceSet
    from repro_torch.core import list_detectors, registry
    from repro_torch.core.constants import ENTER, ET, EXC, NAME
    from repro_torch.launch.cardcheck import digest, findings_gate
    from repro_torch.readers.jsonl import iter_chunks_jsonl
    from repro_torch.tracegen import baseline, gol
    register_extensions()
    launches = {}
    try:
        took = {n: registry.get_op(n).takes_device for n in EXT_OPS}
        if took != dict.fromkeys(EXT_OPS, False) | {"my_analysis": True}:
            raise AssertionError(f"extensions: takes_device {took}")
        reset_counts()
        t0 = time.perf_counter()
        got = trace.diagnose()
        wall = time.perf_counter() - t0
        launches["extensions diagnose"] = expect_counts(
            "extensions diagnose", DIAG_LAUNCHES)
        mine = np.asarray(got["detector"]).astype(str) == "gpu_idle"
        reset_counts()
        own = trace.run("gpu_idle")
        expect_counts("extensions gpu_idle", NO_LAUNCHES)
        same = (_rows(got.mask(~mine)) == _rows(MAIN_RESULTS["diagnose"])
                and _rows(got.mask(mine)) == _rows(own))
        log(f"[extensions] diagnose + gpu_idle on main-10M {wall:.3f} s: "
            f"{len(got)} findings ({int(mine.sum())} gpu_idle), phase 13's "
            f"findings {'unchanged' if same else 'CHANGED'} | {SMI[0]}")
        if not same:
            raise AssertionError("extensions: diagnose with gpu_idle is not "
                                 "the built-in findings plus gpu_idle's")
        # an application whose ranks idle past the threshold: gpu_idle
        # fires, and the built-in findings stay as they are
        app = gol(nprocs=64, iters=8, imbalance=0.8, seed=3, device="cuda")
        reset_counts()
        got = app.diagnose()
        expect_counts("extensions gol diagnose", DIAG_LAUNCHES)
        mine = np.asarray(got["detector"]).astype(str) == "gpu_idle"
        built_in = app.diagnose(detectors=sorted(
            set(list_detectors()) - {"gpu_idle"}))
        err = findings_gate(got, app.diagnose(device="cpu"))
        same = (_rows(got.mask(~mine)) == _rows(built_in)
                and _rows(got.mask(mine)) == _rows(app.run("gpu_idle")))
        log(f"[extensions] diagnose + gpu_idle on gol(64 ranks, imbalance "
            f"0.8): {len(got)} findings ({int(mine.sum())} gpu_idle), the "
            f"built-in findings {'unchanged' if same else 'CHANGED'}, "
            f"within the CPU route's (max_abs_err {err:.6g})")
        if not same or not mine.any():
            raise AssertionError("extensions: gpu_idle on gol")
        reset_counts()
        t0 = time.perf_counter()
        busiest = trace.run("busiest_function")
        top = trace.query().my_analysis(top=3)
        host_s = time.perf_counter() - t0
        expect_counts("extensions host ops", NO_LAUNCHES)
        prof = trace.flat_profile()
        vals = np.nan_to_num(np.asarray(prof[EXC], np.float64))
        want = str(prof[NAME][int(np.argmax(vals))])
        log(f"[extensions] busiest_function {busiest!r} (card flat_profile "
            f"{want!r}), my_analysis {top[0][:2]}... {host_s:.3f} s, no "
            f"launch")
        if busiest != want or len(top) != 3:
            raise AssertionError(f"extensions: busiest_function {busiest!r}"
                                 f" against {want!r}")
        runs = [baseline(nprocs=8, iters=n, device="cuda") for n in (12, 16)]
        delta = TraceSet(runs).iteration_count_delta(marker="iteration")
        log(f"[extensions] iteration_count_delta {delta} (want 32)")
        if delta != 32:
            raise AssertionError(f"extensions: iteration_count_delta {delta}")
        # the user reader over stream-0.5M's shards, converted
        t0 = time.perf_counter()
        mine_paths = []
        for p in stream_paths:
            (frame,) = list(iter_chunks_jsonl(p, 1 << 30))
            mine_paths.append(write_myfmt(frame, os.path.join(
                d, os.path.basename(p)[:-len(".jsonl")] + ".myfmt")))
        conv_s = time.perf_counter() - t0
        one = Trace.open(mine_paths[0])
        if one.device.type != "cuda":
            raise AssertionError(f"extensions: a user reader's trace on "
                                 f"{one.device}")
        folds = {}
        for label, paths in (("jsonl", stream_paths),
                             (EXT_READER, mine_paths)):
            reset_counts()
            t0 = time.perf_counter()
            res = Trace.open(paths, streaming=True, fold="chunks",
                             chunk_rows=STREAM_CHUNK_ROWS,
                             device="cuda").flat_profile()
            folds[label] = (digest(res), time.perf_counter() - t0,
                            expect_counts(f"extensions fold {label}", dict(
                                NO_LAUNCHES, seg_sum=len(paths))))
        launches["extensions fold myfmt"] = folds[EXT_READER][2]
        same = folds["jsonl"][0] == folds[EXT_READER][0]
        log(f"[extensions] fold=\"chunks\" flat_profile over "
            f"{len(mine_paths)} shards: "
            f"{EXT_READER} iter_chunks {folds[EXT_READER][1]:.3f} s, jsonl "
            f"{folds['jsonl'][1]:.3f} s, seg_sum x {len(mine_paths)} each, "
            f"bits {'equal' if same else 'DIFFER'} (converted in "
            f"{conv_s:.2f} s) | {SMI[0]}")
        if not same:
            raise AssertionError("extensions: the user reader's fold is not "
                                 "the jsonl reader's bits")
        counts = Trace.open(mine_paths, streaming=True,
                            chunk_rows=STREAM_CHUNK_ROWS,
                            device="cuda").enter_counts()
        want = {}
        for p in mine_paths:
            cols = {n: (v, c) for n, v, c in _myfmt_columns(p)}
            codes, cats = cols[ET]
            names, ncats = cols[NAME]
            enter = codes == int(np.flatnonzero(cats == ENTER)[0])
            for k, v in zip(*np.unique(ncats[names[enter]],
                                       return_counts=True)):
                want[str(k)] = want.get(str(k), 0) + int(v)
        log(f"[extensions] enter_counts streamed over {EXT_READER}: "
            f"{sum(counts.values())} enters, "
            f"{'equal' if counts == want else 'DIFFER'} to the files' count")
        if counts != want:
            raise AssertionError("extensions: enter_counts differs")
    finally:
        unregister_extensions()
    return launches


def phase_parallel(wants, pool, workers, paths, d) -> dict:
    """stream-0.5M's jsonl shards (``paths``), and the same events as one
    file in ``d``, through ``processes=`` work units in a spawn pool on
    the card: each op the eager bits, within the gate of the CPU parallel
    route, every trace kernel launched as on the eager route, no worker on
    the card.  Returns each route's launches."""
    from repro_torch import Trace
    expect = {"seg_sum": 2, "pair_sum": 3, "time_bin": 1, "hist_bin": 1}
    joined = os.path.join(d, "joined.jsonl")
    with open(joined, "wb") as out:
        for p in paths:
            with open(p, "rb") as f:
                out.write(f.read())
    with open(joined, "rb") as f:
        n_events = sum(1 for _ in f)
    log(f"[parallel] {n_events} events in {len(paths)} jsonl shards "
        f"and one joined file ({os.path.getsize(joined) / 1e6:.1f} MB), "
        f"{workers} workers")
    launches = {}
    for route, src in (("shards", paths), ("one file", joined)):
        st = Trace.open(src, streaming=True, chunk_rows=STREAM_CHUNK_ROWS,
                        device="cuda", processes=workers)
        st._pool = pool
        res, launches[f"parallel {route}"] = _route_bits(
            "parallel", f"{route} x{workers}", OPS,
            lambda op, kw: st.run(op, **kw), wants, n_events, expect,
            pooled=st)
        for (op, kw), r in zip(OPS, res):
            t0 = time.perf_counter()
            on_cpu = st.run(op, device="cpu", **kw)
            cpu_s = time.perf_counter() - t0
            err = same_result(op, r, on_cpu)
            log(f"[parallel] {route:8s} {op:17s} cpu parallel route "
                f"{cpu_s:.3f} s, max_abs_err {err:.6g} | {SMI[0]}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the other trace formats
# ---------------------------------------------------------------------------

#: the two ops of the formats phase's streamed, pooled and restricted
#: routes, and their launches
FORMAT_OPS = [OPS[0], OPS[4]]
FORMAT_LAUNCHES = {"seg_sum": 1, "pair_sum": 1, "time_bin": 0, "hist_bin": 0}
#: chrome's chunked routes read a file of stream-0.5M's first 8 ranks (their
#: messages among themselves): its incremental JSON-array decoder is the
#: slow reader at 0.5M
CHROME_STREAM_RANKS = range(8)
#: the restricted plans: ranks a ProcSpan unit of each must hold for the
#: worker to run (2 or more units survive the pruning)
RESTRICTED = {"chrome": range(4), "otf2j": range(16)}
#: a synthetic SPMD step: a ``while`` whose body holds a ``dot`` and an
#: all-reduce, an all-gather and a reduce-scatter over 8 devices; 60,000
#: trips, so ``max_events_per_proc`` (200,000 calls, 50,000 trips) binds
HLO_SPMD = """\
HloModule pipit_spmd_step

%sum (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

%body (p: (s32[], bf16[2048,4096])) -> (s32[], bf16[2048,4096]) {
  %p = (s32[], bf16[2048,4096]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = bf16[2048,4096] get-tuple-element(%p), index=1
  %w = bf16[4096,4096] parameter(1)
  %d = bf16[2048,4096] dot(%x, %w), lhs_contracting_dims={1}, \
rhs_contracting_dims={0}
  %ar = bf16[2048,4096] all-reduce(%d), replica_groups={{0,1,2,3,4,5,6,7}}, \
to_apply=%sum
  %ag = bf16[16384,4096] all-gather(%ar), \
replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %rs = bf16[2048,4096] reduce-scatter(%ag), \
replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}, to_apply=%sum
  %one = s32[] constant(1)
  %ni = s32[] add(%i, %one)
  ROOT %t = (s32[], bf16[2048,4096]) tuple(%ni, %rs)
}

%cond (p: (s32[], bf16[2048,4096])) -> pred[] {
  %p = (s32[], bf16[2048,4096]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(60000)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

ENTRY %main_spmd (a: bf16[2048,4096]) -> bf16[2048,4096] {
  %a = bf16[2048,4096] parameter(0)
  %z = s32[] constant(0)
  %t0 = (s32[], bf16[2048,4096]) tuple(%z, %a)
  %loop = (s32[], bf16[2048,4096]) while(%t0), condition=%cond, body=%body
  ROOT %r = bf16[2048,4096] get-tuple-element(%loop), index=1
}
"""
HLO = dict(n_procs=8, max_events_per_proc=200_000)
HLO_OPS = [("flat_profile", {}), ("comm_matrix", {}),
           ("time_profile", {"num_bins": 32}),
           ("message_histogram", {"bins": 10})]
HLO_LAUNCHES = {"seg_sum": 1, "pair_sum": 1, "time_bin": 1, "hist_bin": 1}


def _canonical_events(ev) -> tuple:
    """The uniform event table every format must read back (the canonical
    form of ``tests/test_conformance.py``): event types other than Enter
    and Leave as Instant, absent thread and message columns at their
    defaults, rows in (process, thread, time) order."""
    from repro_torch.core.constants import (ET, MSG_SIZE, NAME, PARTNER,
                                            PROC, TAG, THREAD, TS)
    n = len(ev)

    def strings(c):
        col = ev.column(c)
        if hasattr(col, "codes"):
            return col.categories.astype(str)[col.codes]
        return np.asarray(col).astype(str)

    def ints(c, fill):
        return (np.asarray(ev[c], np.int64) if c in ev
                else np.full(n, fill, np.int64))

    et = strings(ET)
    et = np.where((et == "Enter") | (et == "Leave"), et, "Instant")
    size = (np.nan_to_num(np.asarray(ev[MSG_SIZE], np.float64), nan=-1.0)
            if MSG_SIZE in ev else np.full(n, -1.0))
    cols = (np.asarray(ev[TS], np.int64), et, strings(NAME), ints(PROC, 0),
            ints(THREAD, 0), size, ints(PARTNER, -1), ints(TAG, 0))
    order = np.lexsort((cols[0], cols[4], cols[3]))
    return tuple(c[order] for c in cols)


def _same_events(label, got, want) -> None:
    if len(got[0]) != len(want[0]) or not all(
            np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{label}: the canonical events differ from "
                             f"the source's")


def _formats_hlo() -> None:
    """The synthetic SPMD module modeled at the H100 table's rates: the
    four ops on the card within the gate of the CPU path."""
    from repro_torch import Trace
    from repro_torch.analysis.roofline import HW
    from repro_torch.core.constants import ENTER, ET
    t0 = time.perf_counter()
    t = Trace.from_hlo(HLO_SPMD, **HLO)
    read_s = time.perf_counter() - t0
    calls = int(t.events.cat(ET).mask_eq(ENTER).sum())
    log(f"[formats] hlo: {calls} calls on {t.num_processes} devices "
        f"({len(t)} rows) modeled at {HW} in {read_s:.2f} s")
    reset_counts()
    card = _route(HLO_OPS, lambda op, kw: t.run(op, **kw))
    expect_counts("formats hlo", HLO_LAUNCHES)
    for (op, kw), (res, wall) in zip(HLO_OPS, card):
        t0 = time.perf_counter()
        on_cpu = t.run(op, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        err = same_result(op, res, on_cpu)
        log(f"[formats] hlo {op:17s} {json.dumps(kw):20s} card {wall:.3f} "
            f"s | cpu path {cpu_s:.3f} s, max_abs_err {err:.6g} | {SMI[0]}")
    bd = t.comm_comp_breakdown()
    span = float(np.sum(np.asarray(bd["span"], np.float64)))
    # rounded, so that a sum that is 0 up to f64 rounding prints as 0
    shares = {c: round(float(np.sum(np.asarray(bd[c], np.float64))) / span,
                       6) + 0.0
              for c in ("comp_only", "comm_only", "overlap")}
    log(f"[formats] hlo modeled step: span {span / t.num_processes / 1e9:.4f}"
        f" s a device; shares compute only {shares['comp_only']:.4f}, "
        f"communication only {shares['comm_only']:.4f}, overlap "
        f"{shares['overlap']:.4f}")


def _restriction(fmt):
    from repro_torch.core import Filter
    from repro_torch.core.constants import PROC
    return Filter(PROC, "in", list(RESTRICTED[fmt]))


def _selection_digest(trace, fmt) -> str:
    """The digest of ``flat_profile`` over ``trace``'s eager selection of
    the ranks of ``fmt``'s restricted plan."""
    from repro_torch.launch.cardcheck import digest
    op, kw = FORMAT_OPS[0]
    sel = trace.query().filter(_restriction(fmt)).collect()
    return digest(sel.run(op, **kw))


def _write_format(args) -> tuple:
    """Run in a pool worker: write ``events`` in one format, timed:
    (format, seconds, bytes on disk)."""
    from repro_torch.readers import write_chrome, write_csv, write_otf2_json
    fmt, events, path = args
    write = {"csv": write_csv, "chrome": write_chrome,
             "chrome-8": write_chrome,
             "otf2j": lambda e, p: write_otf2_json(e, p,
                                                   split_locations=True)}
    t0 = time.perf_counter()
    write[fmt](events, path)
    wall = time.perf_counter() - t0
    size = (sum(os.path.getsize(os.path.join(r, f))
                for r, _d, fs in os.walk(path) for f in fs)
            if os.path.isdir(path) else os.path.getsize(path))
    return fmt, wall, size


def phase_formats(src, wants, pool, d) -> dict:
    """stream-0.5M (``src``: phase 7's eager trace of its jsonl shards, on
    the card; ``wants``: its seven op calls' digests) written as csv,
    chrome and an otf2j directory archive in ``d`` (one pool worker a
    file, while the parent checks the HLO reader), and read back on every
    route.  Returns the launches of every route but the HLO trace's,
    summed."""
    from repro_torch import Trace
    from repro_torch.core import executor, registry
    from repro_torch.core.constants import DERIVED_COLUMNS, PARTNER, PROC
    from repro_torch.launch.cardcheck import digest
    workers = pool.processes
    ev = src.events.drop(*DERIVED_COLUMNS)
    n_events = len(ev)
    want_events = _canonical_events(ev)
    files = {"csv": os.path.join(d, "stream.csv"),
             "chrome": os.path.join(d, "stream.json"),
             "otf2j": os.path.join(d, "stream_otf2"),
             "chrome-8": os.path.join(d, "stream_8ranks.json")}
    # the first 8 ranks' events, less their messages to and from the
    # other 56 ranks (``comm_matrix`` refuses a partner outside the trace)
    n8 = len(CHROME_STREAM_RANKS)
    first8 = (np.asarray(ev[PROC]) < n8) & (np.asarray(ev[PARTNER]) < n8)
    t0 = time.perf_counter()
    pending = pool.get().map_async(_write_format, [
        (fmt, ev.mask(first8) if fmt == "chrome-8" else ev, path)
        for fmt, path in files.items()])
    # the HLO reader needs none of the files: it runs while they are
    # written
    _formats_hlo()
    written = pending.get()
    for fmt, wall, size in written:
        log(f"[formats] {fmt:8s} written in {wall:.2f} s, {size / 1e6:.1f} "
            f"MB | {SMI[0]}")
    log(f"[formats] {n_events} events written in 4 files by 4 pool "
        f"workers, and the HLO check, in {time.perf_counter() - t0:.2f} s")
    del ev
    launches, want_sel = {}, {}
    for fmt in ("csv", "chrome", "otf2j"):
        path = files[fmt]
        if registry.sniff_format(path) != fmt:
            raise AssertionError(f"{path}: sniffed as "
                                 f"{registry.sniff_format(path)}")
        t0 = time.perf_counter()
        eager = Trace.open(path, device="cuda")
        open_s = time.perf_counter() - t0
        _same_events(f"formats {fmt} eager", _canonical_events(eager.events),
                     want_events)
        log(f"[formats] {fmt:8s} eager open {open_s:.2f} s (sniffed), "
            f"canonical events the source's | {SMI[0]}")
        _res, launches[f"formats {fmt} eager"] = _route_bits(
            "formats", f"{fmt} eager", OPS,
            lambda op, kw: eager.run(op, **kw), wants, n_events,
            ROUTE_LAUNCHES)
        if fmt == "otf2j":
            want_sel["otf2j"] = _selection_digest(eager, "otf2j")
        del eager
    # chrome's chunked routes run on the first 8 ranks' file
    path8 = files["chrome-8"]
    eager8 = Trace.open(path8, device="cuda")
    wants8 = [digest(eager8.run(op, **kw)) for op, kw in FORMAT_OPS]
    want_sel["chrome"] = _selection_digest(eager8, "chrome")
    n8 = len(eager8)
    del eager8
    unit_type = {"csv": registry.ByteSpan, "chrome": registry.ProcSpan,
                 "otf2j": registry.ProcSpan}
    for fmt in ("csv", "otf2j", "chrome"):
        path = path8 if fmt == "chrome" else files[fmt]
        want = (wants8 if fmt == "chrome"
                else [wants[OPS.index(o)] for o in FORMAT_OPS])
        n = n8 if fmt == "chrome" else n_events
        size = "8 ranks" if fmt == "chrome" else "0.5M"
        st = Trace.open(path, streaming=True, chunk_rows=STREAM_CHUNK_ROWS,
                        device="cuda")
        k = 1 if fmt == "csv" else len(FORMAT_OPS)
        _r, launches[f"formats {fmt} streamed"] = _route_bits(
            "formats", f"{fmt} {size} streamed", FORMAT_OPS[:k],
            lambda op, kw: st.run(op, **kw), want[:k], n,
            FORMAT_LAUNCHES if k > 1 else dict(FORMAT_LAUNCHES, pair_sum=0))
        pst = Trace.open(path, streaming=True, chunk_rows=STREAM_CHUNK_ROWS,
                         device="cuda", processes=workers)
        pst._pool = pool
        units = executor.plan_units(pst, (), workers)
        if len(units) < 2 or not all(isinstance(u, unit_type[fmt])
                                     for u in units):
            raise AssertionError(f"formats {fmt}: units {units[:3]}")
        log(f"[formats] {fmt:8s} {len(units)} "
            f"{unit_type[fmt].__name__} units")
        _r, launches[f"formats {fmt} pooled"] = _route_bits(
            "formats", f"{fmt} {size} x{workers}", FORMAT_OPS,
            lambda op, kw: pst.run(op, **kw), want, n, FORMAT_LAUNCHES,
            pooled=pst)
        if fmt not in RESTRICTED:
            continue
        flt = _restriction(fmt)
        _r, launches[f"formats {fmt} restricted"] = _route_bits(
            "formats", f"{fmt} {size} ranks {RESTRICTED[fmt].start}-"
            f"{RESTRICTED[fmt].stop - 1} x{workers}", FORMAT_OPS[:1],
            lambda op, kw: pst.query().filter(flt).run(op, **kw),
            [want_sel[fmt]], n, dict(FORMAT_LAUNCHES, pair_sum=0),
            pooled=pst)
        log(f"[formats] {fmt:8s} restricted plan: {pst.units_pruned} of "
            f"{len(units)} units pruned, {len(pst.units_cuda)} run")
        if pst.units_pruned != len(units) - len(pst.units_cuda) or \
                pst.units_pruned == 0:
            raise AssertionError(f"formats {fmt}: pruning {pst.units_pruned}"
                                 f" of {len(units)}, {len(pst.units_cuda)} "
                                 f"run")
    log(f"[formats] launches by route {json.dumps(launches)}")
    total = dict.fromkeys(ROUTE_LAUNCHES, 0)
    for counts in launches.values():
        for k, v in counts.items():
            total[k] += v
    return {"formats": total}


# ---------------------------------------------------------------------------
# phases 11-13: TraceSet comparison and the detector suite
# ---------------------------------------------------------------------------

#: the set phase's second member: the same application at half the ranks,
#: about 5M events over 32 ranks (the paper's Fig. 12 use: one
#: application at two process counts; 10M until the run passed 1,000 s
#: with the folds of phase 14b)
SCALE = dict(nprocs=32, events_per_proc=156_250, calls_per_iter=500, seed=1)
SET_LABELS = ["main-64", "scale-32"]
#: the five set ops, and a trace op mapped over the members
SET_OPS = [("diff_flat_profile", {}), ("regression_report", {}),
           ("scaling_analysis", {}), ("diff_time_profile", {}),
           ("diff_load_imbalance", {})]
MAPPED = ("message_histogram", {"bins": 10})
#: the set op not held against the CPU route: diff_flat_profile holds
#: seg_sum there, and its members' own bits are checked all the same
SET_NO_CPU = "diff_load_imbalance"
#: launches of the five set ops plus the mapped op over two members: one
#: per member and kernel (the profile cache answers the other two
#: ``flat_profile`` passes)
SET_LAUNCHES = {"seg_sum": 2, "pair_sum": 2, "time_bin": 2, "hist_bin": 2}
#: the SetQuery plan's two chained ops: one profile a member
PLAN_LAUNCHES = {"seg_sum": 2, "pair_sum": 0, "time_bin": 0, "hist_bin": 0}
#: the set-stream phase's ops, on stream-0.5M's shards and its first half
STREAM_SET_OPS = [("regression_report", {}), ("diff_time_profile", {}),
                  ("scaling_analysis", {})]
#: the set-stream phase's ops on ``fold="chunks"`` members:
#: ``regression_report`` (each member's ``flat_profile`` fold) and
#: ``scaling_analysis`` (its whole-stream pass on the host, and the
#: members' profiles, cached by then)
FOLD_SET_OPS = [STREAM_SET_OPS[0], STREAM_SET_OPS[2]]
#: the closed loop: the five pathologies on 64 ranks x 1,170 iterations
#: (1,048,320 events), each at the reference tests' middle magnitude
PATHO = dict(nprocs=64, iters=1_170, seed=0)
PATHO_MAGNITUDE = {"late_sender": 4.0, "straggler": 2.0,
                   "serialization": 5.0, "imbalance": 4.0,
                   "efficiency_drop": 0.6}
#: ``diagnose`` launches ``stragglers``' one ``seg_sum`` call
DIAG_LAUNCHES = {"seg_sum": 1, "pair_sum": 0, "time_bin": 0, "hist_bin": 0}


def expect_counts(label: str, expect: dict) -> dict:
    """The trace kernels' launch counts since :func:`reset_counts`: equal to
    ``expect``, every launch on its path (:data:`MAIN_PATHS`)."""
    from repro_torch import kernels
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in kernels.TRACE_KERNELS}
    paths = {name: dict(getattr(kernels, name).PATH_LAUNCHES)
             for name in MAIN_PATHS}
    log(f"[{label}] launches {json.dumps(launches)}; by path "
        f"{json.dumps(paths)}")
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    off = [k for k, p in MAIN_PATHS.items() if paths[k][p] != launches[k]]
    if off:
        raise AssertionError(f"{label}: calls off their path {off}")
    return launches


def _columns_are_members(op, res, own):
    """Each member's column in a set result is that member's own eager op
    on the card, bit for bit: ``own[op][i]`` is member i's result."""
    from repro_torch.core import NAME
    names = [str(x) for x in res[NAME]] if NAME in res.columns else None
    for i, lbl in enumerate(SET_LABELS):
        if op in ("diff_flat_profile", "regression_report"):
            prof = own["flat_profile"][i]
            want = dict(zip(map(str, prof[NAME]),
                            np.asarray(prof["time.exc"])))
            got = dict(zip(names, np.asarray(res[f"time.exc|{lbl}"])))
        elif op == "diff_load_imbalance":
            imb = own["load_imbalance"][i]
            want = dict(zip(map(str, imb[NAME]),
                            np.asarray(imb["time.exc.imbalance"])))
            got = dict(zip(names, np.asarray(res[f"imbalance|{lbl}"])))
        elif op == "scaling_analysis":
            prof = own["flat_profile"][i]
            want = dict(zip(map(str, prof[NAME]),
                            np.asarray(prof["time.exc"])))
            row = [str(r) for r in res["Run"]].index(lbl)
            got = {c: np.asarray(res[c])[row] for c in res.columns
                   if c in want}
        else:  # diff_time_profile: target's profile minus baseline's
            base, tgt = own["time_profile"]
            cols = [c for c in res.columns if c not in ("bin", "bin_frac")]
            z = np.zeros(len(res))
            for c in cols:
                d = (np.asarray(tgt[c]) if c in tgt.columns else z) - \
                    (np.asarray(base[c]) if c in base.columns else z)
                if not np.array_equal(np.asarray(res[c]), d):
                    raise AssertionError(f"set {op}: column {c} is not "
                                         f"the members' own profiles")
            return
        bad = [k for k, v in got.items() if k in want and v != want[k]]
        if bad or not got:
            raise AssertionError(f"set {op} {lbl}: columns {bad} are not "
                                 f"the member's own bits")


def phase_set(trace, kept: dict) -> dict:
    """set-15M: main-10M and scale-5M as one ``TraceSet`` on the card.
    The five set ops and a mapped ``message_histogram``: within the gate
    of the CPU route, each member's columns the member's own op on the
    card bit for bit, :data:`SET_LAUNCHES`; a ``SetQuery`` plan chaining
    two ops prepares each member once.  Keeps the set's members in
    ``kept`` for phase 14.  Returns the launches."""
    from repro_torch import Trace, TraceSet
    from repro_torch.core import NAME, Filter, structure
    from repro_torch.launch.cardcheck import digest, set_gate
    from repro_torch.tracegen import big_events
    t0 = time.perf_counter()
    scale = Trace.from_events(big_events(**SCALE), device="cuda")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scale._ensure_structure()
    struct_s = time.perf_counter() - t0
    log(f"[set] scale-5M: {len(scale)} events over "
        f"{scale.num_processes} ranks, generated in {gen_s:.2f} s, "
        f"structure {struct_s:.2f} s (host) | {SMI[0]}")
    ts = TraceSet([trace, scale], labels=SET_LABELS)
    kept["members"] = list(ts)
    launches = {}
    reset_counts()
    card = _route(SET_OPS + [MAPPED], lambda op, kw: ts.run(op, **kw))
    launches["set"] = expect_counts("set", SET_LAUNCHES)
    members = list(ts)
    own = {"flat_profile": [], "load_imbalance": [], "time_profile": []}
    t0 = time.perf_counter()
    for t in members:
        own["flat_profile"].append(t.flat_profile(metrics=["time.exc"]))
        own["load_imbalance"].append(t.load_imbalance())
        own["time_profile"].append(t.time_profile())
    own_s = time.perf_counter() - t0
    tp_scale = max(float(np.abs(np.asarray(p[c])).max())
                   for p in own["time_profile"] for c in p.columns
                   if not c.startswith("bin_"))
    for (op, kw), (res, wall) in zip(SET_OPS + [MAPPED], card):
        if op == SET_NO_CPU:
            _columns_are_members(op, res, own)
            log(f"[set] {op:19s} card {wall:.3f} s | cpu route not run | "
                f"members' own bits equal | {SMI[0]}")
            continue
        t0 = time.perf_counter()
        on_cpu = ts.run(op, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        if op == MAPPED[0]:
            err = max(same_result(op, a, b) for a, b in zip(res, on_cpu))
            bits = all(digest(a) == digest(t.run(op, **kw))
                       for a, t in zip(res, members))
        else:
            err = set_gate(op, res, on_cpu, member_scale=(
                tp_scale if op == "diff_time_profile" else None))
            _columns_are_members(op, res, own)
            bits = True
        log(f"[set] {op:19s} card {wall:.3f} s | cpu route {cpu_s:.3f} s, "
            f"max_abs_err {err:.6g} | members' own bits "
            f"{'equal' if bits else 'DIFFER'} | {SMI[0]}")
        if not bits:
            raise AssertionError(f"set {op}: not the members' own bits")
    log(f"[set] the members' own eager ops on the card: {own_s:.2f} s")
    # one SetQuery plan, two chained ops: each member selected and
    # profiled once; each result the eager selection's bits
    sel = Filter(NAME, "not-in", [QUERY_DROP])
    q = ts.query().filter(sel)
    derive0 = structure.DERIVE_CALLS
    reset_counts()
    plan = _route([("regression_report", {}), ("diff_flat_profile", {})],
                  lambda op, kw: q.run(op, **kw))
    launches["set plan"] = expect_counts("set plan", PLAN_LAUNCHES)
    derived = structure.DERIVE_CALLS - derive0
    first = q.collect()
    if derived > len(members) or any(
            a is not b for a, b in zip(first, q.collect())):
        raise AssertionError("set plan: a member was prepared twice")
    eager = TraceSet([t.query().filter(sel).collect() for t in members],
                     labels=SET_LABELS)
    for (op, _kw), (res, wall) in zip(
            [("regression_report", {}), ("diff_flat_profile", {})], plan):
        same = digest(res) == digest(eager.run(op))
        log(f"[set] plan filter(Name not-in [{QUERY_DROP}]).{op}: "
            f"{wall:.3f} s, structure derived {derived}x | eager "
            f"selection's bits {'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"set plan {op}: not the eager bits")
    del eager, q, first
    return launches


def phase_set_stream(paths, pool, workers) -> dict:
    """set-stream: ``TraceSet.open([stream-0.5M's shards, their first
    half], streaming=True)`` serially and with ``processes=`` over the
    shared pool: each op the eager set's bits; one pool serves the set and
    no worker initializes CUDA; then the set of ``fold="chunks"`` members:
    ``regression_report`` (one ``seg_sum`` a member's chunk) and
    ``scaling_analysis`` (no launch: the profiles are cached), each within
    the set gate of the eager set's, its process counts, durations,
    speedups and totals exact.  Returns the launches."""
    import warnings

    from repro_torch import TraceSet
    from repro_torch.launch.cardcheck import digest, set_gate
    members = [paths, paths[:len(paths) // 2]]
    labels = [f"stream-{len(m)}" for m in members]
    t0 = time.perf_counter()
    eager = TraceSet.open(members, labels=labels, device="cuda")
    for t in eager:
        t._ensure_structure()
    open_s = time.perf_counter() - t0
    eager_res = [r for r, _w in _route(
        STREAM_SET_OPS, lambda op, kw: eager.run(op, **kw))]
    wants = [digest(r) for r in eager_res]
    log(f"[set-stream] eager set of {[len(t) for t in eager]} events "
        f"opened in {open_s:.2f} s | {SMI[0]}")
    del eager
    launches = {}
    for route, procs in (("serial", None), (f"pooled x{workers}", workers)):
        st = TraceSet.open(members, streaming=True,
                           chunk_rows=STREAM_CHUNK_ROWS, processes=procs,
                           labels=labels, device="cuda")
        if procs:
            if len({id(m._pool) for m in st}) != 1 or st[0]._pool is not \
                    pool:
                raise AssertionError("set-stream: the members do not share "
                                     "the scheduler's one pool")
        q = st.query()
        reset_counts()
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="parallel streaming",
                                    category=RuntimeWarning)
            res = _route(STREAM_SET_OPS, lambda op, kw: q.run(op, **kw))
        launches[f"set stream {route.split()[0]}"] = expect_counts(
            f"set-stream {route}", {"seg_sum": 2, "pair_sum": 0,
                                    "time_bin": 2, "hist_bin": 0})
        if procs:
            units = [m.units_cuda for m in q.collect()]
            if any(len(u) < 2 or any(u) for u in units):
                raise AssertionError(f"set-stream: units {units}")
        for (op, _kw), (r, wall), want in zip(STREAM_SET_OPS, res, wants):
            same = digest(r) == want
            log(f"[set-stream] {route:12s} {op:19s} {wall:.3f} s | eager "
                f"set's bits {'equal' if same else 'DIFFER'} | {SMI[0]}")
            if not same:
                raise AssertionError(f"set-stream {route} {op}: not the "
                                     f"eager bits")
    fst = TraceSet.open(members, streaming=True,
                        chunk_rows=STREAM_CHUNK_ROWS, labels=labels,
                        device="cuda", fold="chunks")
    # each shard's 7,813 events are one chunk
    chunks = sum(len(m) for m in members)
    for op, kw in FOLD_SET_OPS:
        want = eager_res[STREAM_SET_OPS.index((op, kw))]
        res, wall, launches[f"set stream fold {op}"] = _counted_fold(
            lambda: fst.run(op, **kw), "set-stream", op, kw, chunks)
        err = set_gate(op, res, want)
        kernel = _fold_kernel(op, kw)
        log(f"[set-stream] fold         {op:19s} {wall:.3f} s | within the "
            f"set gate of the eager set's, max_abs_err {err:.6g} | "
            f"{f'{kernel} x {chunks}' if kernel else 'no launch'} | "
            f"{SMI[0]}")
    return launches


def phase_diagnose(trace, paths, pool, workers, d) -> dict:
    """The detector suite on the card: the closed loop (each pathology's
    detector names the ground truth at top 1; the clean baseline gives no
    findings), ``diagnose`` at 10M against the CPU route with one
    ``seg_sum`` launch, and over stream-0.5M streamed, pooled and from pack
    the eager digest.  Returns the launches."""
    import warnings

    from repro_torch import Trace
    from repro_torch.launch.cardcheck import digest, findings_gate
    from repro_torch.tracegen import (PATHOLOGIES, baseline, big_trace,
                                      pathology_trace)
    for p in sorted(PATHOLOGIES):
        t0 = time.perf_counter()
        tr, gt = pathology_trace(p, magnitude=PATHO_MAGNITUDE[p],
                                 device="cuda", **PATHO)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        top = tr.run(PATHOLOGIES[p])
        det_s = time.perf_counter() - t0
        row = {c: top[c][0] for c in top.columns} if len(top) else {}
        ok = (len(top) > 0 and str(row["detector"]) == gt.detector
              and (gt.process == -1 or int(row["process"]) == gt.process)
              and (not gt.function or str(row["function"]) == gt.function)
              and row["t_start"] < gt.t_end and row["t_end"] > gt.t_start)
        log(f"[diagnose] {p:15s} {len(tr)} events built in {build_s:.2f} s;"
            f" {PATHOLOGIES[p]} {det_s:.3f} s: top 1 "
            f"{row.get('location')!s} ({gt.detector}, rank {gt.process}, "
            f"{gt.function or '-'}) {'recovered' if ok else 'MISSED'}")
        if not ok:
            raise AssertionError(f"diagnose: {p} not recovered at top 1")
    clean = baseline(device="cuda", **PATHO)
    found = clean.diagnose()
    log(f"[diagnose] clean baseline, {len(clean)} events: {len(found)} "
        f"findings")
    if len(found):
        raise AssertionError("diagnose: findings on the clean baseline")
    del tr, clean
    launches = {}
    reset_counts()
    t0 = time.perf_counter()
    card = trace.diagnose()
    card_s = time.perf_counter() - t0
    launches["diagnose"] = expect_counts("diagnose", DIAG_LAUNCHES)
    MAIN_RESULTS["diagnose"] = card
    t0 = time.perf_counter()
    err = findings_gate(card, trace.diagnose(device="cpu"))
    log(f"[diagnose] main-10M: {len(card)} findings "
        f"({sorted(set(map(str, card['detector'])))}), card {card_s:.3f} s,"
        f" cpu route {time.perf_counter() - t0:.3f} s, max_abs_err "
        f"{err:.6g} | {SMI[0]}")
    # every route over stream-0.5M: the eager digest
    eager = Trace.open(paths, device="cuda")
    want = digest(eager.diagnose())
    del eager
    packs = big_trace(os.path.join(d, "stream-pack"), format="pack",
                      **STREAM)
    pst = Trace.open(paths, streaming=True, chunk_rows=STREAM_CHUNK_ROWS,
                     device="cuda", processes=workers)
    pst._pool = pool
    routes = {
        "streamed": lambda: Trace.open(paths, streaming=True,
                                       chunk_rows=STREAM_CHUNK_ROWS,
                                       device="cuda").diagnose(),
        f"pooled x{workers}": pst.diagnose,
        "pack": lambda: Trace.open(packs, device="cuda").diagnose(),
        "pack streamed": lambda: Trace.open(
            packs, streaming=True, device="cuda").diagnose(),
    }
    for route, run in routes.items():
        reset_counts()
        pst.units_cuda = []
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="parallel streaming",
                                    category=RuntimeWarning)
            got = run()
        wall = time.perf_counter() - t0
        launches[f"diagnose {route.split()[0]}"] = expect_counts(
            f"diagnose {route}", DIAG_LAUNCHES)
        same = digest(got) == want
        log(f"[diagnose] stream-0.5M {route:12s} {wall:.3f} s | eager digest "
            f"{'equal' if same else 'DIFFER'} | {SMI[0]}")
        if not same:
            raise AssertionError(f"diagnose {route}: not the eager digest")
        if route.startswith("pooled") and (len(pst.units_cuda) < 2
                                           or any(pst.units_cuda)):
            raise AssertionError(f"diagnose pooled: units {pst.units_cuda}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the rest of the paper's analysis API
# ---------------------------------------------------------------------------

#: the twelve host-op calls of phase 14 on main-10M
ANALYSIS_CALLS = [
    ("idle_time", {}), ("comm_by_process", {}),
    ("comm_by_process", {"output": "count"}),
    ("comm_over_time", {"num_bins": 32}), ("comm_comp_breakdown", {}),
    ("logical_steps", {}), ("calculate_lateness", {}),
    ("lateness_by_process", {}), ("critical_path_analysis", {}),
    ("activity_series", {"num_bins": 512}), ("detect_pattern", {}),
    ("detect_pattern", {"start_event": "iteration"}),
]
#: the three ops with streaming forms, checked on every route
ANALYSIS_STREAMED = [("idle_time", {}), ("comm_by_process", {}),
                     ("comm_over_time", {"num_bins": 32})]
#: the ops the lazy plan of phase 6 runs here
ANALYSIS_PLAN = [("idle_time", {}), ("comm_over_time", {"num_bins": 32})]
#: ranks of the multirun scaling study (``tortuga``, paper Fig. 12)
STUDY_RANKS = (16, 32, 64, 128)
#: host ops launch no kernel
NO_LAUNCHES = {"seg_sum": 0, "pair_sum": 0, "time_bin": 0, "hist_bin": 0}
#: one ``seg_sum`` a run of the study: four profiles not yet cached
STUDY_LAUNCHES = dict(NO_LAUNCHES, seg_sum=len(STUDY_RANKS))


def _size(res) -> str:
    """A result's size for the log: rows, or a list's frames."""
    if isinstance(res, list):
        return f"{len(res)} frames"
    if isinstance(res, tuple):
        return f"{len(res[0])} bins"
    return f"{len(res)} rows"


def _analysis_in_memory(trace) -> tuple:
    """The twelve calls on main-10M on the card, no launch, each the bits of
    the same call on a CPU Trace of the same events (sharing their derived
    structure); then the lazy plan.  Returns (launches, the streamed ops'
    digests)."""
    from repro_torch import Trace
    from repro_torch.core import NAME, Filter
    from repro_torch.launch.cardcheck import digest
    launches = {}
    reset_counts()
    card = _route(ANALYSIS_CALLS, lambda op, kw: trace.run(op, **kw))
    launches["analysis"] = expect_counts("analysis", NO_LAUNCHES)
    cpu = Trace(trace.events, label=trace.label, device="cpu")
    cpu._structured, cpu._msg_match = trace._structured, trace._msg_match
    digests = {}
    for (op, kw), (res, wall) in zip(ANALYSIS_CALLS, card):
        if (op, kw) in HOST_FOLD_OPS:
            MAIN_RESULTS[op] = res
        t0 = time.perf_counter()
        want = cpu.run(op, **kw)
        cpu_s = time.perf_counter() - t0
        same = digest(res) == digest(want)
        digests[(op, json.dumps(kw))] = digest(res)
        log(f"[analysis] {op:22s} {json.dumps(kw):30s} card {wall:.3f} s "
            f"| cpu trace {cpu_s:.3f} s | {_size(res)} | bits "
            f"{'equal' if same else 'DIFFER'} | {SMI[0]}")
        if not same:
            raise AssertionError(f"analysis {op}: the card trace's result "
                                 f"is not the CPU trace's bits")
    del cpu

    def plan(q):
        return q.filter(Filter(NAME, "not-in", [QUERY_DROP])) \
            .restrict_processes(QUERY_RANKS)

    reset_counts()
    lazy = _route(ANALYSIS_PLAN,
                  lambda op, kw: plan(trace.query()).run(op, **kw))
    launches["analysis plan"] = expect_counts("analysis plan", NO_LAUNCHES)
    sub = plan(trace.query()).collect()
    for (op, kw), (res, wall) in zip(ANALYSIS_PLAN, lazy):
        same = digest(res) == digest(sub.run(op, **kw))
        log(f"[analysis] plan filter(Name not-in [{QUERY_DROP}])"
            f".restrict_processes(range({len(QUERY_RANKS)})).{op}: "
            f"{wall:.3f} s | eager selection's bits "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"analysis plan {op}: not the eager "
                                 f"selection's bits")
    del sub
    return launches, [digests[(op, json.dumps(kw))]
                      for op, kw in ANALYSIS_STREAMED]


def _multirun(traces, label, expect, why) -> dict:
    """``multirun_analysis`` on the card with the counts reset just before
    and read just after (``expect``, for the reason ``why``), held within
    the gate of the CPU route.  Returns the launches."""
    from repro_torch import Trace
    reset_counts()
    t0 = time.perf_counter()
    card = Trace.multirun_analysis(traces)
    wall = time.perf_counter() - t0
    got = expect_counts(f"multirun {label}", expect)
    t0 = time.perf_counter()
    cpu = Trace.multirun_analysis(traces, device="cpu")
    cpu_s = time.perf_counter() - t0
    if list(card.columns) != list(cpu.columns) or \
            list(card["Run"]) != list(cpu["Run"]):
        raise AssertionError(f"multirun {label}: columns {card.columns} "
                             f"!= {cpu.columns}")
    err = max(gate(np.asarray(card[c]), np.asarray(cpu[c]))
              for c in list(card.columns)[1:])
    log(f"[analysis] multirun {label}: runs "
        f"{[str(r) for r in card['Run']]}, "
        f"{len(card.columns) - 1} functions, card {wall:.3f} s ({why}) | "
        f"cpu route {cpu_s:.3f} s, max_abs_err {err:.6g} | {SMI[0]}")
    return got


def _paper_claims() -> None:
    """``tests/test_ops.py``'s claims on the app generators at their
    defaults, on the card's Traces; no launch."""
    from repro_torch.core import PROC
    from repro_torch.tracegen import (axonn_training, gol, kripke_sweep,
                                      loimos, tortuga)
    reset_counts()
    t0 = time.perf_counter()
    hot = {21, 22, 23, 24, 29}
    idle = [int(p) for p in loimos(device="cuda").idle_time()[PROC]]
    path = kripke_sweep(device="cuda").critical_path_analysis()[0]
    ranks = len(set(np.asarray(path[PROC]).tolist()))
    pats = tortuga(iters=6, device="cuda").detect_pattern(
        start_event="time-loop")
    bd = {v: axonn_training(version=v, device="cuda").comm_comp_breakdown()
          for v in (0, 1, 2)}
    ov = {v: float(np.asarray(b["overlap"]).mean()) for v, b in bd.items()}
    comm = {v: float(np.asarray(b["comm_only"]).mean())
            for v, b in bd.items()}
    late = float(np.asarray(gol(imbalance=0.5, device="cuda")
                            .lateness_by_process()["max_lateness"]).max())
    wall = time.perf_counter() - t0
    expect_counts("analysis claims", NO_LAUNCHES)
    claims = [
        (f"loimos: the hot ranks {sorted(hot)} idle least (last five "
         f"{idle[-5:]})", set(idle[-5:]) == hot),
        (f"kripke_sweep: the critical path ({len(path)} calls) crosses "
         f"{ranks} ranks >= 4", ranks >= 4),
        (f"tortuga(iters=6): detect_pattern(start_event='time-loop') finds "
         f"{len(pats)} iterations", len(pats) == 6),
        (f"axonn_training: overlap v2 {ov[2]:.0f} ns > v0 {ov[0]:.0f} ns; "
         f"exposed comm v1 {comm[1]:.0f}, v2 {comm[2]:.0f} < v0 "
         f"{comm[0]:.0f} ns",
         ov[2] > ov[0] and comm[1] < comm[0] and comm[2] < comm[0]),
        (f"gol(imbalance=0.5): max lateness {late:.0f} ns > 0", late > 0),
    ]
    for text, ok in claims:
        log(f"[analysis] claim {text}: {'holds' if ok else 'FAILS'}")
    if not all(ok for _t, ok in claims):
        raise AssertionError("analysis: a paper claim fails on the card")
    log(f"[analysis] the five claims in {wall:.2f} s")


def _analysis_routes(stream_paths, pool, workers, pack_dir,
                     main_digests) -> dict:
    """The three streamed ops over stream-0.5M (streamed and pooled: the
    eager digest) and pack-10M streamed (main-10M's digest), no launch.
    Returns the launches."""
    import warnings

    from repro_torch import Trace
    from repro_torch.launch.cardcheck import digest
    eager = Trace.open(stream_paths, device="cuda")
    wants = [digest(eager.run(op, **kw)) for op, kw in ANALYSIS_STREAMED]
    del eager
    pst = Trace.open(stream_paths, streaming=True,
                     chunk_rows=STREAM_CHUNK_ROWS, device="cuda",
                     processes=workers)
    pst._pool = pool
    packs = [os.path.join(pack_dir, f"rank_{r}.pack")
             for r in range(MAIN["nprocs"])]
    routes = [
        ("stream-0.5M", "streamed", 1, wants, lambda: Trace.open(
            stream_paths, streaming=True, chunk_rows=STREAM_CHUNK_ROWS,
            device="cuda")),
        ("stream-0.5M", f"pooled x{workers}", 3, wants, lambda: pst),
        ("pack-10M", "streamed", 3, main_digests, lambda: Trace.open(
            packs, streaming=True, device="cuda")),
    ]
    launches = {}
    for data, route, n_ops, want, handle in routes:
        h = handle()
        reset_counts()
        for (op, kw), w in zip(ANALYSIS_STREAMED[:n_ops], want):
            h.units_cuda = []
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.filterwarnings("error", message="parallel streaming",
                                        category=RuntimeWarning)
                got = h.run(op, **kw)
            wall = time.perf_counter() - t0
            same = digest(got) == w
            log(f"[analysis] {data} {route:16s} {op:16s} {wall:.3f} s | "
                f"eager digest {'equal' if same else 'DIFFER'} | {SMI[0]}")
            if not same:
                raise AssertionError(f"analysis {data} {route} {op}: not "
                                     f"the eager digest")
            if h is pst and (len(pst.units_cuda) < 2 or any(pst.units_cuda)):
                raise AssertionError(f"analysis pooled: units "
                                     f"{pst.units_cuda}")
        launches[f"analysis {data} {route.split()[0]}"] = expect_counts(
            f"analysis {data} {route}", NO_LAUNCHES)
    return launches


def phase_analysis(trace, members, stream_paths, pool, workers,
                   d) -> tuple:
    """The rest of the paper's analysis API: main-10M's twelve host calls
    and a lazy plan, ``multirun_analysis`` (the phase's kernel, ``seg_sum``)
    over a scaling study and over set-15M's ``members`` (main-10M and
    scale-5M under their labels, as phase 11's set holds them), the
    paper's claims on the app generators, and the three streamed ops on
    the stream and pack routes.  Returns (the launches, the streamed ops'
    main-10M digests for the live and served phases)."""
    from repro_torch.tracegen import tortuga
    launches, digests = _analysis_in_memory(trace)
    study = [tortuga(nprocs=n, iters=6, device="cuda") for n in STUDY_RANKS]
    launches["analysis multirun study"] = _multirun(
        study, "tortuga study", STUDY_LAUNCHES,
        f"one seg_sum a run: {len(STUDY_RANKS)} profiles not cached yet")
    launches["analysis multirun 10M"] = _multirun(
        members, "set-15M", NO_LAUNCHES,
        "no launch: phase 11's set ops left both members' (time.exc, "
        "device) profiles in the comparison's cache")
    _paper_claims()
    launches.update(_analysis_routes(stream_paths, pool, workers,
                                     os.path.join(d, "pack"), digests))
    return launches, digests


# ---------------------------------------------------------------------------
# phases 15-16: the live and served routes
# ---------------------------------------------------------------------------

#: launches of the seven op calls on every route, cold or incremental
ROUTE_LAUNCHES = {"seg_sum": 2, "pair_sum": 3, "time_bin": 1, "hist_bin": 1}
#: the served phase's op calls over pack-10M (a miss and its library call
#: cost 3.5-5.5 s an op), and their launches
SERVED_OPS = [OPS[0], OPS[4], OPS[5]]
SERVED_LAUNCHES = {"seg_sum": 1, "pair_sum": 1, "time_bin": 0, "hist_bin": 1}
#: rows a chunk group of the live shards holds (commits land whole groups)
LIVE_GROUP_ROWS = 65_536
#: the /live session's shard set: the first 8 live-10M shards
LIVE_SESSION_RANKS = 8
#: the tracer fleet: 8 ranks of about 20,000 events each
FLEET = dict(ranks=8, iters=200, calls=33, flush_every=4096)
#: the fleet's classification windows (seconds of heartbeat age)
FLEET_LAG_S, FLEET_DEAD_S = 30.0, 120.0
#: concurrent identical requests that must coalesce into one execution
COALESCE = 4


def _no_launches(label: str) -> None:
    """Every trace kernel's count since :func:`reset_counts` is 0."""
    from repro_torch import kernels
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in kernels.TRACE_KERNELS}
    log(f"[{label}] launches {json.dumps(launches)}")
    if any(launches.values()):
        raise AssertionError(f"{label}: a cache hit launched {launches}")


def _counted(label: str, run) -> tuple:
    """``run()`` with the counts reset just before and read just after:
    every kernel on its path, launched :data:`ROUTE_LAUNCHES` times.
    Returns (its result, the launches)."""
    reset_counts()
    out = run()
    launches = check_counts(label)
    if launches != ROUTE_LAUNCHES:
        raise AssertionError(f"{label}: launches {launches}, a cold pass "
                             f"launches {ROUTE_LAUNCHES}")
    return out, launches


def start_service(device="cuda"):
    """A ``TraceServer`` on 127.0.0.1:0 on ``device``, its event loop in a
    thread of this process: (server, thread)."""
    import asyncio
    import threading

    from repro_torch.core.accel import resolve_device
    from repro_torch.serving.tracequery import TraceServer, TraceService
    box, ready = {}, threading.Event()

    def serve():
        async def main():
            box["server"] = await TraceServer(TraceService(device=device),
                                              port=0).start()
            ready.set()
            await box["server"].serve_forever()

        try:
            asyncio.run(main())
        finally:
            ready.set()

    thread = threading.Thread(target=serve, name="tracequery-loop",
                              daemon=True)
    thread.start()
    if not ready.wait(60) or "server" not in box:
        raise RuntimeError("the trace-query server did not start")
    server = box["server"]
    if server.service.device != resolve_device(device):
        raise AssertionError(f"service on {server.service.device}")
    log(f"[tracequery] server on 127.0.0.1:{server.port}, device "
        f"{server.service.device}")
    return server, thread


def _write_live(events, d):
    """main-10M's events as 64 append-mode shards, each rank's first half
    (whole groups) committed; returns (paths, writers with their rest)."""
    from repro_torch.core import PROC
    from repro_torch.readers.pack import PackWriter
    procs = np.asarray(events[PROC])
    bounds = np.searchsorted(procs, np.arange(MAIN["nprocs"] + 1))
    paths, rest = [], []
    for r in range(MAIN["nprocs"]):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        half = lo + (hi - lo) // 2 // LIVE_GROUP_ROWS * LIVE_GROUP_ROWS
        p = os.path.join(d, f"rank_{r}.pack")
        w = PackWriter.open_append(p, chunk_rows=LIVE_GROUP_ROWS,
                                   fsync=False)
        w.append(events.take(np.arange(lo, half)))
        w.commit()
        paths.append(p)
        rest.append((w, half, hi))
    return paths, rest


def _live_stage(label, lt, paths, launches, eager=None) -> list:
    """At ``lt``'s watermark: the seven op calls incrementally (cache on),
    on a cold ``cache=False`` handle and eagerly over the same committed
    rows, one digest each.  ``eager``: the eager route's digests over
    these rows when they are known already (phase 5's, once every row is
    committed: the same events), in place of materializing them again."""
    from repro_torch import Trace
    from repro_torch.launch.cardcheck import digest
    inc, launches[f"live {label} incremental"] = _counted(
        f"live {label} incremental",
        lambda: _route(OPS, lambda op, kw: lt.run(op, **kw)))
    cold_h = Trace.open(paths, live=True, cache=False, device="cuda")
    if cold_h.watermark.rows != lt.watermark.rows:
        raise AssertionError("the cold handle pinned other rows")
    cold, launches[f"live {label} cold"] = _counted(
        f"live {label} cold",
        lambda: _route(OPS, lambda op, kw: cold_h.run(op, **kw)))
    if eager is None:
        t0 = time.perf_counter()
        eager_t = lt.materialize()
        mat_s = time.perf_counter() - t0
        runs, launches[f"live {label} eager"] = _counted(
            f"live {label} eager",
            lambda: _route(OPS, lambda op, kw: eager_t.run(op, **kw)))
        eager = [(digest(r), f"eager {w:.3f} s") for r, w in runs]
        log(f"[live] {label}: watermark {lt.watermark.rows} rows "
            f"({len(eager_t)} materialized in {mat_s:.2f} s), finalized "
            f"{lt.watermark.finalized} | {SMI[0]}")
        del eager_t
    else:
        eager = [(d, "eager: phase 5's") for d in eager]
        log(f"[live] {label}: watermark {lt.watermark.rows} rows, "
            f"finalized {lt.watermark.finalized} | {SMI[0]}")
    for i, (op, kw) in enumerate(OPS):
        same = digest(inc[i][0]) == digest(cold[i][0]) == eager[i][0]
        log(f"[live] {label} {op:17s} {json.dumps(kw, default=str):34s} "
            f"incremental {inc[i][1]:.3f} s | cold {cold[i][1]:.3f} s | "
            f"{eager[i][1]} | bits {'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"live {label} {op}: incremental, cold "
                                 f"and eager differ")
    return [r for r, _w in inc]


def _live_polls(client, paths, before_commit: bool) -> None:
    """``POST /live`` over the first live-10M shards: before a commit 200
    then 429 ``watermark_stalled`` with ``retry_after_ms``; after it 200."""
    from repro_torch.serving.client import RemoteError
    live = client.open_live(paths[:LIVE_SESSION_RANKS])
    t0 = time.perf_counter()
    out = live.poll("flat_profile", digest_only=True)
    wall = time.perf_counter() - t0
    log(f"[tracequery] /live 200: {out['watermark']['rows']} rows, "
        f"advanced {out['advanced_rows']}, {wall:.3f} s")
    if not before_commit:
        if out["advanced_rows"] <= 0:
            raise AssertionError("/live: no advance after the commit")
        return
    try:
        live.poll("flat_profile", digest_only=True)
    except RemoteError as e:
        if e.status != 429 or e.code != "watermark_stalled" or \
                e.extra.get("retry_after_ms", 0) <= 0:
            raise
        log(f"[tracequery] /live {e.status} {e.code}, retry_after_ms "
            f"{e.extra['retry_after_ms']}")
    else:
        raise AssertionError("/live: a poll with no growth was served")


def _live_fold(lf, paths) -> dict:
    """The fold phase's live check: ``lf`` (``fold="chunks"``, folded at
    the first watermark) refreshed after the growth; each op call
    re-queried, folding only the new rows into its stored bounded state
    (an op that needs the statistics pre-pass takes the full pass,
    counted apart), within the gate of a cold ``cache=False`` fold pass,
    one launch a folded chunk.  Returns the re-queries' launches."""
    from repro_torch import Trace, kernels
    from repro_torch.core import streaming
    from repro_torch.launch.cardcheck import op_gate
    names = [mod.__name__.rsplit(".", 1)[1] for mod in kernels.TRACE_KERNELS]
    lf.refresh()
    cold_h = Trace.open(paths, live=True, cache=False, device="cuda",
                        fold="chunks")
    stats0 = streaming.LIVE_STATS_PASSES
    totals = dict.fromkeys(names, 0)
    full = 0
    for op, kw in OPS:
        runs = []
        for label, h in (("incremental", lf), ("cold", cold_h)):
            reset_counts()
            streaming.FOLDED_CHUNKS = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = h.run(op, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            expect = dict.fromkeys(names, 0)
            expect[_fold_kernel(op, kw)] = streaming.FOLDED_CHUNKS
            got = expect_counts(f"live fold {label} {op}", expect)
            if label == "incremental":
                totals = {k: totals[k] + got[k] for k in names}
            runs.append((res, wall, streaming.FOLDED_CHUNKS))
        (inc, inc_s, inc_n), (cold, cold_s, cold_n) = runs
        err = op_gate(op, inc, cold)
        passes = streaming.LIVE_STATS_PASSES - stats0 - full
        full += passes
        log(f"[live] fold {op:17s} {json.dumps(kw, default=str):34s} "
            f"incremental {inc_s:.3f} s ({inc_n} chunks"
            f"{', the full pass: it needs the pre-pass' if passes else ''})"
            f" | cold {cold_s:.3f} s ({cold_n} chunks) | within the gate, "
            f"max_abs_err {err:.6g} | {SMI[0]}")
    needs = sum(op in ("time_profile", "message_histogram") for op, _ in OPS)
    if full != needs:
        raise AssertionError(f"live fold: {full} full passes for the "
                             f"pre-pass, expected {needs}")
    return totals


def phase_live(main_digests, client, analysis_digests) -> dict:
    """live-10M: main-10M's events as 64 append-mode shards grown in two
    commits a rank; at each watermark the seven op calls incrementally,
    cold and eagerly give one digest (after ``finalize`` the eager route
    over every row is phase 5's), with :data:`ROUTE_LAUNCHES` each; a repeat with no growth launches nothing;
    no op falls back to the full pass.  ``POST /live`` over 8 of the
    shards around the second commit.  Phase 14's three streamed ops run
    at the first watermark and are checked at the final one: folded on
    incrementally and on a cold handle, the main-10M digest with no
    launch.  Returns the routes' launches."""
    import tempfile

    from repro_torch import Trace
    from repro_torch.core import streaming
    from repro_torch.launch.cardcheck import digest
    from repro_torch.tracegen import big_events
    launches = {}
    fallbacks = streaming.INCREMENTAL_FALLBACKS
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        events = big_events(**MAIN, calls_per_iter=500)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        paths, rest = _write_live(events, d)
        lt = Trace.open(paths, live=True, device="cuda")
        log(f"[live] {len(events)} events generated in {gen_s:.2f} s; "
            f"first commits of {len(paths)} shards in "
            f"{time.perf_counter() - t0:.2f} s (groups of "
            f"{LIVE_GROUP_ROWS} rows) | {SMI[0]}")
        _live_stage("half", lt, paths, launches)
        t0 = time.perf_counter()
        for op, kw in ANALYSIS_STREAMED:
            lt.run(op, **kw)
        log(f"[live] half: the three analysis ops folded in "
            f"{time.perf_counter() - t0:.3f} s")
        lf = Trace.open(paths, live=True, device="cuda", fold="chunks")
        t0 = time.perf_counter()
        for op, kw in OPS:
            lf.run(op, **kw)
        log(f"[live] half: the seven op calls with fold=\"chunks\" in "
            f"{time.perf_counter() - t0:.3f} s")
        _live_polls(client, paths, before_commit=True)
        t0 = time.perf_counter()
        for w, half, hi in rest:
            w.append(events.take(np.arange(half, hi)))
            w.commit()
            w.finalize(sidecar=False)
        del events, rest
        log(f"[live] second commits and finalize in "
            f"{time.perf_counter() - t0:.2f} s; refresh to "
            f"{lt.refresh().rows} rows")
        _live_polls(client, paths, before_commit=False)
        last = _live_stage("all", lt, paths, launches, eager=main_digests)
        reset_counts()
        again = _route(OPS, lambda op, kw: lt.run(op, **kw))
        _no_launches("live repeat")
        launches["live repeat"] = dict.fromkeys(ROUTE_LAUNCHES, 0)
        if any(a is not b for (a, _w), b in zip(again, last)):
            raise AssertionError("live repeat: not the stored results")
        log(f"[live] repeat with no growth: {len(OPS)} stored results, "
            f"{sum(w for _r, w in again):.4f} s")
        cold_h = Trace.open(paths, live=True, cache=False, device="cuda")
        reset_counts()
        for (op, kw), want in zip(ANALYSIS_STREAMED, analysis_digests):
            t0 = time.perf_counter()
            inc = digest(lt.run(op, **kw))
            inc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cold = digest(cold_h.run(op, **kw))
            cold_s = time.perf_counter() - t0
            same = inc == cold == want
            log(f"[live] all {op:16s} incremental {inc_s:.3f} s | cold "
                f"{cold_s:.3f} s | main-10M digest "
                f"{'equal' if same else 'DIFFER'} | {SMI[0]}")
            if not same:
                raise AssertionError(f"live analysis {op}: incremental, "
                                     f"cold and eager differ")
        launches["live analysis"] = expect_counts("live analysis",
                                                  NO_LAUNCHES)
        del cold_h
        launches["live fold"] = _live_fold(lf, paths)
        del lf
        n_fb = streaming.INCREMENTAL_FALLBACKS - fallbacks
        log(f"[live] incremental fallbacks {n_fb}")
        if n_fb:
            raise AssertionError(f"{n_fb} live ops fell back to the full "
                                 f"pass")
        del lt
    return launches


def _fleet_write(d) -> list:
    """8 ``Tracer`` ranks with sinks under ``d``: iterations of calls that
    each send a message to one of the first 7 ranks (the survivors, whose
    comm matrix holds no partner past them); returns the shard paths."""
    from repro_torch.runtime.tracer import Tracer
    paths = []
    peers = FLEET["ranks"] - 1
    for r in range(FLEET["ranks"]):
        sink = os.path.join(d, f"rank_{r}.pack")
        tr = Tracer(process=r, sink=sink, flush_every=FLEET["flush_every"],
                    fsync=False)
        for _ in range(FLEET["iters"]):
            with tr.span("iteration"):
                for c in range(FLEET["calls"]):
                    with tr.span(f"compute_{c % 3}"):
                        tr.message("send", partner=(r + 1) % peers,
                                   size=float(64 << (c % 10)))
        tr.flush()
        paths.append(sink)
    return paths


def phase_fleet(client) -> None:
    """A tracer fleet with one rank's heartbeat back-dated past
    ``dead_timeout``: ``LiveTraceSet`` names it missing and its survivors'
    seven op calls are a direct live open's bits; ``POST /live`` on the
    fleet answers 206 partial naming it."""
    import tempfile

    from repro_torch import Trace
    from repro_torch.core.liveset import LiveTraceSet
    from repro_torch.launch.cardcheck import digest
    from repro_torch.readers.pack import committed_prefix
    from repro_torch.runtime.tracer import read_heartbeat, write_heartbeat
    dead = FLEET["ranks"] - 1
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = _fleet_write(d)
        rows = [committed_prefix(p)["rows"] for p in paths]
        hb = read_heartbeat(paths[dead])
        write_heartbeat(paths[dead], dead, hb["events"], hb["ts_max"],
                        hb["seq"], wall=time.time() - 2 * FLEET_DEAD_S)
        log(f"[fleet] {len(paths)} tracer ranks, {sum(rows)} events "
            f"committed ({min(rows)}-{max(rows)} a rank) in "
            f"{time.perf_counter() - t0:.2f} s; rank {dead}'s heartbeat "
            f"back-dated {2 * FLEET_DEAD_S:.0f} s")
        ls = LiveTraceSet(d, lag_timeout=FLEET_LAG_S,
                          dead_timeout=FLEET_DEAD_S, device="cuda")
        direct = Trace.open(paths[:dead], live=True, cache=False,
                            device="cuda")
        for op, kw in OPS:
            val, cov, wm = ls.run(op, **kw)
            if cov.missing != [dead]:
                raise AssertionError(f"fleet: missing {cov.missing}")
            same = digest(val) == digest(direct.run(op, **kw))
            log(f"[fleet] {op:17s} {json.dumps(kw, default=str):34s} "
                f"survivors {cov.included} ({wm.rows} rows) | bits "
                f"{'equal' if same else 'DIFFER'} to a direct live open")
            if not same:
                raise AssertionError(f"fleet {op}: not the direct bits")
        part = client.open_liveset(d, lag_timeout=FLEET_LAG_S,
                                   dead_timeout=FLEET_DEAD_S).poll(
            "flat_profile", min_advance_rows=0, digest_only=True)
        if not part["partial"] or part["missing_ranks"] != [dead]:
            raise AssertionError(f"/live liveset: {part.get('partial')} "
                                 f"{part.get('missing_ranks')}")
        log(f"[tracequery] /live liveset 206 partial, missing_ranks "
            f"{part['missing_ranks']}")
        # the survivors as a set of per-rank live handles: the comparison
        # of direct live opens of the same ranks
        from repro_torch import TraceSet
        t0 = time.perf_counter()
        ts = ls.to_traceset()
        got = ts.regression_report()
        set_s = time.perf_counter() - t0
        labels = [f"rank{r}" for r in range(dead)]
        want = TraceSet([Trace.open([p], live=True, device="cuda")
                         for p in paths[:dead]],
                        labels=labels).regression_report()
        same = ts.labels == labels and digest(got) == digest(want)
        log(f"[fleet] to_traceset(): {len(ts)} survivors {ts.labels}, "
            f"regression_report {set_s:.3f} s | bits "
            f"{'equal' if same else 'DIFFER'} to direct live opens")
        if not same or any(m.device != ls.device for m in ts):
            raise AssertionError("fleet to_traceset: not the direct bits")


def phase_served(client, pack_dir, main_digests,
                 analysis_digests) -> dict:
    """pack-10M's 64 shards through the service (``streaming=True``): each
    of :data:`SERVED_OPS` the library call's bits on the same handle
    configuration (and phase 5's), :data:`SERVED_LAUNCHES` on the misses,
    none on a repeat, and
    ``COALESCE`` identical concurrent requests executed once; phase 14's
    three streamed ops, a miss the library's digest (phase 14 showed the
    library call over these shards gives main-10M's) and a repeat a hit,
    neither launching.  Returns the routes' launches."""
    import threading

    from repro_torch import Trace
    from repro_torch.launch.cardcheck import digest
    from repro_torch.serving import protocol
    from repro_torch.serving.client import ServiceClient
    shards = [os.path.join(pack_dir, f"rank_{r}.pack")
              for r in range(MAIN["nprocs"])]
    remote = client.open(shards, streaming=True)
    launches = {}
    reset_counts()
    served = _route(SERVED_OPS,
                    lambda op, kw: remote.query().run(op, **kw))
    launches["served miss"] = expect_counts("served miss", SERVED_LAUNCHES)
    lib_h = Trace.open(shards, streaming=True, cache=False, device="cuda")
    lib = _route(SERVED_OPS, lambda op, kw: lib_h.run(op, **kw))
    reset_counts()
    hits, metas = [], []
    for op, kw in SERVED_OPS:
        t0 = time.perf_counter()
        remote.query().run(op, **kw)
        hits.append(time.perf_counter() - t0)
        metas.append(dict(client.last_meta))
    _no_launches("served hit")
    launches["served hit"] = dict.fromkeys(ROUTE_LAUNCHES, 0)
    for i, (op, kw) in enumerate(SERVED_OPS):
        (got, wall), (want, lib_s) = served[i], lib[i]
        same = (protocol.result_digest(got) == protocol.result_digest(want)
                == metas[i]["digest"]
                and digest(want) == main_digests[OPS.index((op, kw))])
        log(f"[tracequery] {op:17s} {json.dumps(kw, default=str):34s} "
            f"served {wall:.3f} s | hit {hits[i]:.4f} s (cached "
            f"{metas[i]['cached']}) | library {lib_s:.3f} s | digest "
            f"{'equal' if same else 'DIFFER'} | {SMI[0]}")
        if not same or not metas[i]["cached"]:
            raise AssertionError(f"served {op}: not the library digest, "
                                 f"or the repeat was no hit")
    reset_counts()
    for (op, kw), want in zip(ANALYSIS_STREAMED, analysis_digests):
        t0 = time.perf_counter()
        got = remote.query().run(op, **kw)
        wall = time.perf_counter() - t0
        miss = dict(client.last_meta)
        t0 = time.perf_counter()
        remote.query().run(op, **kw)
        hit_s = time.perf_counter() - t0
        hit = dict(client.last_meta)
        same = (digest(got) == want and protocol.result_digest(got)
                == miss["digest"] == hit["digest"])
        log(f"[tracequery] {op:17s} {json.dumps(kw):34s} served {wall:.3f} "
            f"s | hit {hit_s:.4f} s (cached {hit['cached']}) | library "
            f"digest {'equal' if same else 'DIFFER'} | {SMI[0]}")
        if not same or miss["cached"] or not hit["cached"]:
            raise AssertionError(f"served {op}: not the library digest, "
                                 f"or no miss then hit")
    launches["served analysis"] = expect_counts("served analysis",
                                                NO_LAUNCHES)
    # identical concurrent requests: one execution, the rest coalesce
    op, kw = OPS[0]
    st0 = client.stats()["service"]
    barrier, out = threading.Barrier(COALESCE), []

    def send():
        with ServiceClient("127.0.0.1", client.port) as c:
            barrier.wait(timeout=60)
            out.append(c.open(shards, streaming=True).query().run(
                op, cache=False, digest_only=True, **kw))

    threads = [threading.Thread(target=send) for _ in range(COALESCE)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    st1 = client.stats()["service"]
    executed = st1["executed"] - st0["executed"]
    coalesced = st1["coalesced"] - st0["coalesced"]
    log(f"[tracequery] {COALESCE} concurrent {op}: executed {executed}, "
        f"coalesced {coalesced}, {wall:.3f} s; digests "
        f"{len(set(out))} distinct")
    if executed != 1 or coalesced != COALESCE - 1 or len(out) != COALESCE \
            or set(out) != {metas[0]["digest"]}:
        raise AssertionError("concurrent identical requests did not "
                             "coalesce into one execution")
    launches.update(_served_set_and_diagnose(client, shards))
    return launches


def _served_set_and_diagnose(client, shards) -> dict:
    """``/setquery`` (``open_set`` over all 64 shards and the first 32,
    streamed) and ``/diagnose`` over pack-10M, then ``/diagnose`` and
    ``/query`` of ``idle_time`` on a ``"fold": "chunks"`` spec: the
    library's digests (phase 14b's fold results for the last two), a miss
    launching as the library call does (the folded ``diagnose`` one
    ``seg_sum`` a chunk), a repeat a cache hit that launches nothing.
    Returns the launches."""
    from repro_torch import Trace, TraceSet
    from repro_torch.serving import protocol
    members = [shards, shards[:len(shards) // 2]]
    labels = [f"pack-{len(m)}" for m in members]
    rset = client.open_set(members, streaming=True, labels=labels)
    remote = client.open(shards, streaming=True)
    folded = client.open(shards, streaming=True, fold="chunks")
    cases = [
        ("set", "/setquery regression_report",
         lambda: rset.query().regression_report(),
         lambda: TraceSet.open(members, streaming=True, labels=labels,
                               cache=False,
                               device="cuda").regression_report(),
         {"seg_sum": 2, "pair_sum": 0, "time_bin": 0, "hist_bin": 0}),
        ("diagnose", "/diagnose", remote.diagnose,
         lambda: Trace.open(shards, streaming=True, cache=False,
                            device="cuda").diagnose(), DIAG_LAUNCHES),
        # fold="chunks": phase 14b's library fold results
        ("fold diagnose", "/diagnose fold=chunks", folded.diagnose,
         lambda: FOLD_RESULTS["diagnose"],
         dict(NO_LAUNCHES, seg_sum=_pack_chunks(shards))),
        ("fold idle_time", "/query idle_time fold=chunks",
         lambda: folded.query().idle_time(),
         lambda: FOLD_RESULTS["idle_time"], NO_LAUNCHES),
    ]
    launches = {}
    for name, label, served, library, expect in cases:
        reset_counts()
        t0 = time.perf_counter()
        got = served()
        wall = time.perf_counter() - t0
        launches[f"served {name} miss"] = expect_counts(
            f"served {name} miss", expect)
        t0 = time.perf_counter()
        want = library()
        lib_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        served()
        hit_s = time.perf_counter() - t0
        meta = dict(client.last_meta)
        _no_launches(f"served {name} hit")
        launches[f"served {name} hit"] = dict.fromkeys(ROUTE_LAUNCHES, 0)
        same = (protocol.result_digest(got) == protocol.result_digest(want)
                == meta["digest"])
        log(f"[tracequery] {label:28s} served {wall:.3f} s | hit "
            f"{hit_s:.4f} s (cached {meta['cached']}) | library "
            f"{lib_s:.3f} s | digest {'equal' if same else 'DIFFER'} | "
            f"{SMI[0]}")
        if not same or not meta["cached"]:
            raise AssertionError(f"served {label}: not the library digest, "
                                 f"or the repeat was no hit")
    return launches


def phase_live_and_served(main_digests, pack_dir,
                          analysis_digests) -> dict:
    """Phases 15-16 with the plan cache on (the earlier phases run with it
    off), around one trace-query server; the live store is cleared and
    every service thread stopped after."""
    from repro_torch.core import plancache
    from repro_torch.core.scheduler import get_scheduler
    from repro_torch.serving.client import ServiceClient
    plancache.clear()
    plancache.configure(enabled=True)
    server, thread = start_service()
    try:
        with ServiceClient("127.0.0.1", server.port, tenant="smoke") as c:
            launches = phase_live(main_digests, c, analysis_digests)
            plancache.clear()
            phase_fleet(c)
            launches.update(phase_served(c, pack_dir, main_digests,
                                         analysis_digests))
            st = c.stats()
            log(f"[tracequery] service {json.dumps(st['service'])}")
            c.shutdown(grace=30)
        thread.join(timeout=60)
        if thread.is_alive():
            raise RuntimeError("the trace-query server did not stop")
    finally:
        plancache.clear()
        plancache.configure(enabled=False)
        get_scheduler().shutdown()
    return launches


# ---------------------------------------------------------------------------
# phase 17: timing on the main path's inputs
# ---------------------------------------------------------------------------

def _bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(launches, calls, routes) -> list:
    """One row per trace kernel, timed on the inputs of its first call on
    the main path; a kernel whose later main-path calls had other shapes
    also times each of those (``other_calls``)."""
    from repro_torch import kernels
    src = "src/repro_torch/csrc/{}.cu"
    replaces = {"seg_sum": "src/repro/kernels/seg_sum.py:60",
                "pair_sum": "src/repro/kernels/pair_sum.py:64",
                "time_bin": "src/repro/kernels/time_bin.py:74",
                "hist_bin": "src/repro/kernels/hist_bin.py:59"}
    rows = []
    for mod in kernels.TRACE_KERNELS:
        name = mod.__name__.rsplit(".", 1)[1]
        (args, kw), *others = calls[name]
        row = {"name": name, "route": "cuda", "source": src.format(name),
               "replaces": replaces[name], "launches": launches[name],
               "route_launches": {r: c[name] for r, c in routes.items()}}
        row.update(_time_trace_call(mod, name, args, kw))
        if row["path"] is not None:
            check = exact if name == "hist_bin" else gate
            row.update(_path_prev(mod, name, args, kw, row["path"], check))
        if others:
            row["other_calls"] = [_time_trace_call(mod, name, a, k)
                                  for a, k in others]
        rows.append(row)
    return rows


def _time_trace_call(mod, name, args, kw) -> dict:
    """A trace kernel on one call's inputs: checked against its plain
    version, timed beside it and one library call, with its bound."""
    kern = getattr(mod, name)
    plain = getattr(mod, name + "_plain")
    got, want = kern(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    if name == "hist_bin":
        err = exact(got.cpu().numpy(), want.cpu().numpy())
    else:
        err = gate(got.cpu().numpy(), want.cpu().numpy())
    if name == "seg_sum":
        code, vals, n_seg = args
        n, k = vals.shape
        bytes_moved = n * 4 + n * k * 4 + n_seg * k * 4
        ops = n * k
        idx, acc = code.long(), torch.zeros((n_seg, k), device="cuda")
        library = lambda: acc.index_add_(0, idx, vals)  # noqa: E731
        call = "index_add_"
        path = mod.path(n, n_seg * k)
        keys = code if path == "sorted" else None
        shape = f"N={n} K={k} n_seg={n_seg}"
    elif name == "pair_sum":
        a, b, w, n_a, n_b = args
        n = a.shape[0]
        bytes_moved = n * 12 + n_a * n_b * 4
        ops = n
        flat = a.long() * n_b + b.long()
        acc = torch.zeros(n_a * n_b, device="cuda")
        library = lambda: acc.index_add_(0, flat, w)  # noqa: E731
        call = "index_add_ on flat cell keys"
        path = mod.path(n, n_a * n_b)
        keys = flat.int() if path == "sorted" else None
        shape = f"N={n} {n_a}x{n_b}"
    elif name == "time_bin":
        s, e, f, r = args[:4]
        n_funcs, n_bins = kw["n_funcs"], kw["n_bins"]
        t0, t1 = kw["t0"], kw["t1"]
        n = s.shape[0]
        bytes_moved = n * 16 + n_funcs * n_bins * 4
        # the (record, bin) terms this run's data needs: the bins its
        # span touches, each min, max, sub, clamp, mul, add
        bw = (t1 - t0) / n_bins
        keep = (f >= 0) & (f < n_funcs) & (e > s)
        first = torch.floor((s[keep] - t0) / bw).clamp(0, n_bins)
        end = torch.ceil((e[keep] - t0) / bw).clamp(0, n_bins)
        ops = 6 * float((end - first).clamp_min(0).double().sum())
        library = _time_library(s, e, f, r, n_funcs, n_bins, t0, t1)
        call = ("chain: torch.minimum / torch.maximum / clamp_min / "
                "mul on [N, n_bins], then index_add_")
        path = mod.path(n, n_funcs * n_bins)
        keys = f if path == "sorted" else None
        shape = f"N={n} n_funcs={n_funcs} n_bins={n_bins}"
    else:
        coords, n_bins = args
        n = coords.shape[0]
        bytes_moved = n * 4 + n_bins * 8
        ops = n
        idx = torch.floor(coords).long()
        library = lambda: torch.bincount(idx, minlength=n_bins)  # noqa
        call = "bincount"
        path = mod.path(n_bins)
        keys = None
        shape = f"N={n} n_bins={n_bins}"
    ms = cuda_ms(lambda: kern(*args, **kw), iters=20)
    dev_ms, by_kernel = device_ms(lambda: kern(*args, **kw))
    names = sorted(by_kernel)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=5, warm=1)
    library_ms = cuda_ms(library, iters=20)
    # the wrapper's device sort of the record keys, part of ``ms``
    sort_ms = (cuda_ms(lambda: torch.sort(keys, stable=True), iters=20)
               if keys is not None else 0.0)
    bound_ms, bound_by = _bound(bytes_moved, ops)
    log(f"[timing] {name:8s} {shape:32s} kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms) | plain {plain_ms:.4f} ms | library "
        f"{library_ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}) | of "
        f"which device sort {sort_ms:.4f} ms | device kernels {names}")
    if path == "private":
        sorts = [k for k in names if "sort" in k.lower()]
        if sorts:
            raise AssertionError(f"{name}: a sort kernel on the private "
                                 f"path: {sorts}")
    if path == "narrow" and len(names) != 1:
        raise AssertionError(f"{name}: the narrow path is one device "
                             f"kernel a call, the profiler saw {names}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_call": call,
            "sort_ms": sort_ms, "device_kernels": names, "shape": shape,
            "path": path, "checked": True}


def _time_library(s, e, f, r, n_funcs, n_bins, t0, t1):
    """time_bin as a chain of PyTorch calls: the dense [N, n_bins] overlap
    by broadcasting, then ``index_add_`` by func (the records' filter and
    the bin edges made outside the timed call)."""
    keep = (f >= 0) & (f < n_funcs)
    s, e, r, idx = s[keep], e[keep], r[keep], f[keep].long()
    bw = (t1 - t0) / n_bins
    lo = t0 + bw * torch.arange(n_bins, dtype=torch.float32, device="cuda")
    hi = lo + bw
    acc = torch.zeros((n_funcs, n_bins), device="cuda")

    def library():
        ov = (torch.minimum(e[:, None], hi) - torch.maximum(s[:, None], lo)
              ).clamp_min_(0.0).mul_(r[:, None])
        return acc.index_add_(0, idx, ov)
    return library


def _path_prev(mod, name, args, kw, path, check) -> dict:
    """The path that ``path`` replaced on the main path (:data:`PREV_PATH`)
    on the same inputs, held to the plain version by ``check``."""
    if path not in PREV_PATH:
        return {}
    prev_path = PREV_PATH[path]
    run = getattr(mod, name + "_path")
    prev = lambda: run(prev_path, *args, **kw)  # noqa: E731
    err = check(prev().cpu().numpy(),
                getattr(mod, name + "_plain")(*args, **kw).cpu().numpy())
    out = {"prev_path": prev_path, "prev_ms": cuda_ms(prev, iters=20),
           "prev_device_ms": device_ms(prev)[0], "prev_max_abs_err": err}
    log(f"[timing] {name} the {prev_path} path on the same inputs "
        f"{out['prev_ms']:.4f} ms (device {out['prev_device_ms']:.4f} "
        f"ms, max_abs_err {err:.6g})")
    return out


# ---------------------------------------------------------------------------
# phases 18-21: the serving path
# ---------------------------------------------------------------------------

def phase_serve():
    from repro_torch import kernels
    from repro_torch.core.constants import INC
    from repro_torch.launch import serve as launch
    checks = []

    def hook(phase, logits):
        checks.append(torch.isfinite(logits).all())

    torch.cuda.synchronize()
    reset_peak()
    fa, rt = kernels.flash_attention, kernels.router_topk
    for mod in kernels.MODEL_KERNELS:
        mod.LAUNCHES = 0
    fa.VARIANT_LAUNCHES.update(dict.fromkeys(fa.VARIANT_LAUNCHES, 0))
    rt.VARIANT_CALLS.update(dict.fromkeys(rt.VARIANT_CALLS, 0))
    with DeviceTimer(kernels.MODEL_KERNELS) as timer:
        run = launch.serve(**SERVE, device="cuda", logits_hook=hook)
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in kernels.MODEL_KERNELS}
    by_variant = dict(fa.VARIANT_LAUNCHES)
    router_calls = dict(rt.VARIANT_CALLS)
    kernel_s = timer.seconds_by_kernel()
    peak = torch.cuda.max_memory_allocated()
    cfg = run.engine.cfg
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.topk} + "
        f"{cfg.n_shared_experts} shared, {cfg.param_count() / 1e9:.2f} B "
        f"parameters in {SERVE['dtype']}")
    log(f"[serve] launches {json.dumps(launches)}; flash_attention by "
        f"variant {json.dumps(by_variant)}; router calls by route "
        f"{json.dumps(router_calls)}")
    idle = [k for k in ("flash_attention", "router_topk")
            if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the serving "
                             f"path: {idle}")
    if by_variant["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"prefill attention not all on the "
                             f"tensor-core kernel: {by_variant}")
    waves = -(-SERVE["requests"] // SERVE["batch"])
    calls = cfg.n_layers * waves * SERVE["new_tokens"]
    if router_calls != {"fused": calls, "unfused": 0} or \
            launches["router_topk"] != calls or launches["topk_gating"]:
        raise AssertionError(f"bf16 router calls not all on router_topk: "
                             f"{router_calls}, launches {launches}, "
                             f"expected {calls} fused")
    if len(run.done) != SERVE["requests"] or any(
            len(r.out_tokens) != SERVE["new_tokens"] for r in run.done):
        raise AssertionError("not every request got its tokens")
    bad = [t for r in run.done for t in r.out_tokens
           if not 0 <= t < cfg.vocab]
    if bad:
        raise AssertionError(f"tokens outside [0, {cfg.vocab}): {bad[:5]}")
    if not checks or not all(bool(c) for c in checks):
        raise AssertionError("non-finite logits on the serving path")
    lens = [len(r.prompt) for r in run.done]
    trace = run.tracer.to_trace(device="cuda")
    fp = trace.flat_profile(metrics=(INC,))
    prof = {n: (int(c), float(t)) for n, c, t in
            zip(fp["Name"], fp["count"], fp[INC])}
    need = {"wave", "prefill", "decode", "decode_step"}
    if not need <= set(prof):
        raise AssertionError(f"trace lacks spans {need - set(prof)}")
    if prof["prefill"][0] != waves or \
            prof["decode_step"][0] != waves * (SERVE["new_tokens"] - 1):
        raise AssertionError(f"span counts {prof}")
    prefill_s = prof["prefill"][1] / 1e9 / prof["prefill"][0]
    step_ms = prof["decode_step"][1] / 1e6 / prof["decode_step"][0]
    log(f"[serve] {len(run.done)} requests in {waves} waves, prompt "
        f"lengths {lens}; {run.summary['generated_tokens']} tokens in "
        f"{run.summary['wall_s']} s = {run.summary['tok_per_s']} tok/s")
    log(f"[serve] prefill {prefill_s:.4f} s per wave; decode "
        f"{step_ms:.3f} ms per step; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log("[serve] device time in kernel wrappers: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in sorted(kernel_s.items())))
    log("[serve] trace spans (count, inclusive s): " + ", ".join(
        f"{n} ({c}, {t / 1e9:.4f})" for n, (c, t) in sorted(prof.items())))
    profile_serving(run.engine.model, SERVE,
                    first_wave(run.done, SERVE["batch"]), export=True)
    inputs = timer.inputs
    del run, trace
    torch.cuda.empty_cache()
    return launches, inputs


def first_wave(done, batch: int) -> np.ndarray:
    """The first wave's prompts, left-padded with token 0 to one length as
    the engine pads them: [batch, S] int64."""
    wave = [r.prompt for r in done[:batch]]
    tokens = np.zeros((len(wave), max(map(len, wave))), np.int64)
    for i, p in enumerate(wave):
        tokens[i, tokens.shape[1] - len(p):] = p
    return tokens


def profile_serving(model, spec: dict, wave: np.ndarray,
                    prefill: bool = True, export: bool = False,
                    extras=None) -> dict:
    """The served ``model`` (of ``spec``, a :func:`repro_torch.launch.serve.
    serve` configuration) on the first ``wave`` prefilled (with
    ``extras``), then one prefill (with ``prefill``) and one decode step
    under ``torch.profiler`` (:func:`profile_step`; the decode step's
    export read back with ``export``); then the decode step's ms, host
    clock over 5 synchronized steps.  Returns the profiles by phase."""
    cfg, cache_len = model.cfg, spec["cache_len"]
    tokens = torch.from_numpy(wave).cuda()
    extras = extras or {}
    cache, logits, pos = model.prefill(tokens, cache_len, **extras)
    cur = torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None]
    out = {}
    if prefill:
        out["prefill"] = profile_step(
            f"{cfg.name} prefill",
            lambda: model.prefill(tokens, cache_len, **extras))
    step = lambda: model.decode_step(cache, cur, pos, cache_len)  # noqa
    out["decode"] = profile_step(f"{cfg.name} decode_step", step,
                                 export=export)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"[profile] {cfg.name} decode_step {ms:.3f} ms a step (host clock, "
        f"5 steps, wave [{wave.shape[0]}, {wave.shape[1]}], position {pos})")
    del cache, logits
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 22: the training path, and the analysis of its own trace
# ---------------------------------------------------------------------------

#: the train phase: pipit-lm-100m at full width in bf16, a fault at step 6
TRAIN = dict(steps=12, batch=16, seq=256, fault_at=6, ckpt_every=4,
             dtype="bfloat16")
#: free disk the train phase's checkpoints need (three of 1.4 GB, and one
#: being written)
TRAIN_DISK = 8e9


def phase_train() -> dict:
    """``repro_torch.launch.train_traced`` on pipit-lm-100m at full width:
    one restart, 12 steps, finite and falling losses; the flash forward
    (tensor-core variant) and backward kernels launched once a layer a
    step run, ``seg_sum`` and ``time_bin`` by the trace's analysis on the
    card, whose ``flat_profile`` names the run's spans; the smoke config
    trained 3 steps on the card and on the CPU from one weight set.
    Returns what :func:`train_timing` needs: the trainer, a batch, the
    launches and the first backward call's inputs."""
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.constants import INC
    from repro_torch.launch.train_traced import train_traced
    fa = kernels.flash_attention
    cfg = get_config("pipit-lm-100m")
    captured = {}
    orig_bwd = fa.flash_attention_bwd

    def capture(*args, **kw):          # the first backward call's inputs
        captured.setdefault("call", ([a.detach().clone() for a in args],
                                     dict(kw)))
        return orig_bwd(*args, **kw)

    with tempfile.TemporaryDirectory() as d:
        free = shutil.disk_usage(d).free
        log(f"[train] {free / 1e9:.1f} GB free for checkpoints")
        if free < TRAIN_DISK:
            raise RuntimeError(f"train phase: {free / 1e9:.2f} GB free in "
                               f"{d}, {TRAIN_DISK / 1e9:.0f} GB needed")
        torch.cuda.synchronize()
        reset_peak()
        for mod in kernels.KERNELS:
            mod.LAUNCHES = 0
        fa.LAUNCHES_BWD = 0
        fa.VARIANT_LAUNCHES.update(dict.fromkeys(fa.VARIANT_LAUNCHES, 0))
        fa.VARIANT_LAUNCHES_BWD.update(
            dict.fromkeys(fa.VARIANT_LAUNCHES_BWD, 0))
        fa.flash_attention_bwd = capture
        try:
            t0 = time.perf_counter()
            run = train_traced(**TRAIN, ckpt_dir=d, device="cuda")
            wall = time.perf_counter() - t0
        finally:
            fa.flash_attention_bwd = orig_bwd
        launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                    for mod in kernels.KERNELS}
        launches["flash_attention_bwd"] = fa.LAUNCHES_BWD
        by_variant = dict(fa.VARIANT_LAUNCHES)
        by_variant_bwd = dict(fa.VARIANT_LAUNCHES_BWD)
        peak = torch.cuda.max_memory_allocated()
        out = run.summary
        losses = out["losses"]
        steps_run = len(losses) + out["restarts"]   # a fault follows a step
        log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, vocab "
            f"{cfg.vocab}, {cfg.param_count() / 1e6:.1f} M parameters in "
            f"{TRAIN['dtype']}; batch {TRAIN['batch']} x {TRAIN['seq']}")
        log(f"[train] {out['steps']} steps, {out['restarts']} restart, "
            f"{steps_run} steps run, wall {wall:.2f} s; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}")
        log(f"[train] launches {json.dumps(launches)}; flash_attention by "
            f"variant {json.dumps(by_variant)}, its backward by variant "
            f"{json.dumps(by_variant_bwd)}")
        if out["restarts"] != 1 or out["steps"] != TRAIN["steps"]:
            raise AssertionError(f"train: {out['restarts']} restarts, "
                                 f"{out['steps']} steps")
        if not np.all(np.isfinite(losses)) or \
                not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"train: losses {losses} not finite or "
                                 f"not falling")
        want = cfg.n_layers * steps_run
        if (launches["flash_attention"], by_variant["wgmma"],
                launches["flash_attention_bwd"],
                by_variant_bwd["wgmma"]) != (want, want, want, want):
            raise AssertionError(f"train: flash launches {launches}, "
                                 f"{by_variant}, backward {by_variant_bwd}; "
                                 f"expected {want} each, all wgmma")
        if launches["router_topk"] or launches["topk_gating"] or \
                launches["seg_sum"] < 1 or launches["time_bin"] < 1:
            raise AssertionError(f"train: launches {launches}")
        fp = run.trace.flat_profile(metrics=(INC,))
        prof = {n: (int(c), float(t)) for n, c, t in
                zip(fp["Name"], fp["count"], fp[INC])}
        need = {"train_step", "data_wait", "checkpoint", "restore"}
        if not need <= set(np.asarray(run.flat_profile["Name"]).astype(str)):
            raise AssertionError(f"train: flat_profile lacks "
                                 f"{need - set(prof)}")
        step_s = out["mean_step_time"]
        tokens = TRAIN["batch"] * TRAIN["seq"]
        S = TRAIN["seq"]
        attn = 3 * 4 * cfg.hd * (S * (S + 1) // 2) * TRAIN["batch"] * \
            cfg.n_heads * cfg.n_layers
        flops = 6 * cfg.param_count() * tokens + attn
        log(f"[train] {step_s * 1e3:.2f} ms per step (host clock, steps 2 "
            f"on), {tokens / step_s:.0f} tokens/s, {flops / 1e12:.3f} "
            f"TFLOP a step (6 x parameters x tokens + attention) = "
            f"{flops / step_s / 1e12:.1f} TFLOP/s = "
            f"{flops / step_s / BF16_OPS_PER_S:.2%} of 989 TFLOP/s bf16; "
            f"peak device memory {peak / 2**30:.2f} GiB | {SMI[0]}")
        log("[train] trace spans (count, inclusive s): " + ", ".join(
            f"{n} ({c}, {t / 1e9:.4f})" for n, (c, t) in sorted(
                prof.items())))
        log(f"[train] time_profile: {len(run.time_profile)} bins")
        kept = {"launches": launches, "call": captured["call"]}
        del run
    torch.cuda.empty_cache()
    train_path()
    return kept


def train_stepper():
    """A trainer at the train phase's width, batch and dtype, drawn from
    its seed (a step's kernels do not depend on the weights' values), its
    first step run; returns a call that runs its last step again."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train_traced import DTYPES
    from repro_torch.runtime import Trainer, TrainLoopConfig
    cfg = get_config("pipit-lm-100m")
    step = TRAIN["steps"] - 1
    trainer = Trainer(cfg, TrainLoopConfig(
        steps=TRAIN["steps"], peak_lr=3e-3, warmup_steps=1, ckpt_every=0,
        dtype=DTYPES[TRAIN["dtype"]]), device="cuda")
    batch = _train_batch(cfg, TRAIN, step)
    trainer.train_one(batch, step)
    return lambda: trainer.train_one(batch, step)


def train_timing(kept: dict, stepper) -> list:
    """One train step (``stepper``, :func:`train_stepper`) under
    ``torch.profiler``, and the backward kernel's row on the path's first
    backward call."""
    profile_step("train_step", stepper)
    return [_bwd_row(kept["call"], kept["launches"])]


def train_family_timing(trainfam: dict) -> list:
    """One :data:`TRAIN_CELL_ARCH` train step at phase 26's width and batch
    under ``torch.profiler``: the device's busy share and the router
    forward's (``router_topk``) and backward's (``topk_bwd``) shares of
    device time; then the router backward's rows on the first backward
    call of that run (``topk_gating_bwd``) and of qwen3-moe-235b-a22b's
    (``topk_gating_bwd_e128``), and the flash backward's row at head dim
    96 on phi-3-vision-4.2b's first backward call
    (``flash_attention_bwd_d96``)."""
    spec = next(s for s in TRAIN_FAMILIES if s["arch"] == TRAIN_CELL_ARCH)
    trainer = train_trainer(spec, 100)
    batch = train_batch(trainer.cfg, spec, 0)
    trainer.train_one(batch, 0)
    prof = profile_step(f"train_step {TRAIN_CELL_ARCH}",
                        lambda: trainer.train_one(batch, 0))
    del trainer, batch
    torch.cuda.empty_cache()
    busy = prof["busy_s"]
    if not busy > 0:
        raise AssertionError(f"{TRAIN_CELL_ARCH} train step: the profiler "
                             f"saw no device time")
    share = {part: sum(t for k, t in prof["kernels"].items() if key in k)
             / busy for part, key in (("forward", "router_topk"),
                                      ("backward", "topk_bwd"))}
    log(f"[trainfam] {TRAIN_CELL_ARCH} profiled step: busy "
        f"{busy * 1e3:.3f} ms of {prof['wall_s'] * 1e3:.3f} = "
        f"{busy / prof['wall_s']:.1%}; the router's forward "
        f"{share['forward']:.3%} and backward {share['backward']:.3%} of "
        f"device time | {SMI[0]}")
    rows = []
    for arch, name in ((TRAIN_CELL_ARCH, "topk_gating_bwd"),
                       ("qwen3-moe-235b-a22b", "topk_gating_bwd_e128")):
        fam = trainfam[arch]
        paths = {f"train {arch}": fam["launches"]["topk_gating_bwd"]}
        if "cell" in fam:
            paths[f"train cell {arch}"] = \
                fam["cell"]["launches"]["topk_gating_bwd"]
        rows.append(_topk_bwd_row(name, fam["bwd_call"], paths))
    for arch, fam in trainfam.items():
        if "flash_bwd_call" in fam:
            rows.append(_bwd_row(fam["flash_bwd_call"], {
                "flash_attention_bwd_d96": fam["launches"][
                    "flash_attention_bwd"]}, "flash_attention_bwd_d96"))
    return rows


def _topk_bwd_row(name, call, by_path) -> dict:
    """The router backward's row on one call's inputs from a train run:
    the kernel against its plain version (bit-identical on relaunch,
    ``cardcheck.topk_bwd_err``), the library chain (the three elementwise
    ops, then ``scatter_add_`` into zeros or into the incoming gradient),
    its bound (bytes, :func:`cardcheck.topk_bwd_bound_ms`; operations: 5
    a slot); ``launches`` the Trainer run's."""
    from repro_torch.kernels import topk_gating as tg
    (idx, gates, dgates, dlogits), kw = call
    E = kw.get("E") or dlogits.shape[1]
    T, k = idx.shape

    def kern():
        return tg.topk_gating_bwd(idx, gates, dgates, dlogits, E=E)

    def library():
        c = gates * (dgates - (gates * dgates).sum(1, keepdim=True))
        out = (torch.zeros((T, E), dtype=torch.float32, device=idx.device)
               if dlogits is None else dlogits.clone())
        return out.scatter_add_(1, idx.long(), c)

    got, again = kern(), kern()
    want = tg.topk_gating_bwd_plain(idx, gates, dgates, dlogits, E=E)
    torch.cuda.synchronize()
    if not same_bits(got, again):
        raise AssertionError(f"{name}: relaunch differs")
    err = topk_bwd_err(got, want, gates, dgates)
    lib_err = float((library() - want).abs().max())
    row = _model_row(
        name, "none: src/repro/kernels/topk_gating.py:50 is forward-only",
        {name: by_path[next(iter(by_path))]}, err, kern,
        lambda: tg.topk_gating_bwd_plain(idx, gates, dgates, dlogits, E=E),
        library, 5.0 * T * k / F32_OPS_PER_S * 1e3,
        topk_bwd_bound_ms(T, E, k, dlogits is not None),
        f"idx/gates/dgates [{T}, {k}], dlogits [{T}, {E}] f32"
        f"{' + incoming' if dlogits is not None else ''}")
    row.update(source="src/repro_torch/csrc/topk_gating_bwd.cu",
               path_launches=by_path,
               library="(g dg).sum, g (dg - S), scatter_add_ into zeros",
               library_max_abs_err=lib_err,
               dgates_contiguous=dgates.is_contiguous())
    return row


def _train_batch(cfg, train, step):
    from repro_torch.data import SyntheticLMStream
    stream = SyntheticLMStream(cfg.vocab, train["batch"], train["seq"],
                               seed=1)
    try:
        return stream.batch_at(step)
    finally:
        stream.close()


def train_path(arch: str = "pipit-lm-100m", overrides=None) -> None:
    """The smoke config of ``arch`` (with ``overrides``) in f32 from one
    seeded weight set (and its seeded extras), trained 3 steps on the card
    (kernels) and on the CPU (plain versions): losses within 1e-4 (cuBLAS
    against CPU matmuls, the kernels' summation order).  On the card the
    flash forward and backward launch :func:`train_flash_per_step` a
    step, and an MoE model's f32 router the ``topk_gating`` forward and
    backward kernels once a MoE layer a step; on the CPU nothing
    launches."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models import build_model
    from repro_torch.runtime import Trainer, TrainLoopConfig
    cfg = dataclasses.replace(get_smoke_config(arch), **(overrides or {}))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0)).state_dict()
    moe_layers = sum(s.moe for s in model.specs)
    extras = model_extras(cfg, 8, "cpu", torch.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(cfg, TrainLoopConfig(steps=3, warmup_steps=1,
                                              ckpt_dir=d), device=dev)
            tr.model.load_state_dict(params)
            stream = SyntheticLMStream(cfg.vocab, 8, 64, seed=1)
            reset_model_counts()
            out[dev] = [tr.train_one(dict(stream.batch_at(i), **{
                k: v.to(dev) for k, v in extras.items()}), i)
                for i in range(3)]
            stream.close()
            c = model_counts()
            ran = (c["flash_attention"], c["flash_attention_bwd"],
                   c["topk_gating"], c["topk_gating_bwd"], c["router_topk"])
            want = (3 * train_flash_per_step(cfg),) * 2 + \
                (3 * moe_layers,) * 2 + (0,)
            if ran != (want if dev == "cuda" else (0,) * 5):
                raise AssertionError(f"train path {cfg.name} {dev}: "
                                     f"launches {ran}")
    err = max(abs(a - b) for a, b in zip(out["cuda"], out["cpu"]))
    if not err <= 1e-4:
        raise AssertionError(f"train path {cfg.name}: losses {out} differ "
                             f"by {err}")
    log(f"[train] {cfg.name} f32, 3 steps: losses card "
        f"{out['cuda']} | cpu {out['cpu']} | max abs diff {err:.3g} "
        f"(tol 1e-4)")


def _bwd_row(call, launches, name="flash_attention_bwd") -> dict:
    """The backward kernel on the inputs of a train path's first backward
    call, against its plain version, SDPA's backward (through autograd:
    timed only) and its bound, and the SIMT backward on the same inputs
    (``prev_*``); the row is ``name``, its launches ``launches[name]``."""
    from repro_torch.kernels import flash_attention as fa
    (q, k, v, o, do, lse), kw = call
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    if not all(same_bits(a, b) for a, b in zip(got, again)):
        raise AssertionError("flash_attention_bwd: relaunch differs")
    err, each = flash_bwd_err(got, want, f"{name}, the path's first call")
    log(f"[train] {name} on the path's first call: " + ", ".join(
        f"{n} max abs err {e:.6g} (limit {t:.6g})"
        for n, (e, t) in each.items()))
    qpos = kw.get("q_offset", 0) + torch.arange(Sq, device=q.device)
    visible = float(fa.mask(qpos, torch.arange(Sk, device=q.device),
                            kw.get("causal", True), kw.get("window"),
                            kw.get("prefix_len", 0)).sum())
    ops = 5 * 2.0 * D * visible * B * H   # S, dP, dV, dQ, dK: 2 flops a MAC
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + \
        lse.numel() * 4                   # q, o, dO, dq; k, v, dk, dv; lse
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    with torch.enable_grad():
        out_t = sdpa(qt, kt, vt, is_causal=kw.get("causal", True),
                     enable_gqa=H != KVH)
    do_t = do.transpose(1, 2).contiguous()
    row = _model_row(
        name,
        "none: src/repro/kernels/flash_attention.py:101 is forward-only",
        launches, err, lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                      **kw),
        lambda: fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw),
        lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                    retain_graph=True),
        ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3,
        f"q/k/v/o/dO {list(q.shape)} {str(q.dtype)[6:]}, {visible:.0f} "
        f"visible pairs per head")
    row["library"] = "SDPA backward (torch.autograd.grad)"
    row["source"] = "src/repro_torch/csrc/flash_attention_bwd.cu"
    row["max_abs_err_limit"] = {n: t for n, (_e, t) in each.items()}
    # the SIMT backward, which served this path before, on the same inputs
    simt = lambda: fa.flash_attention_bwd_variant(  # noqa: E731
        "simt", q, k, v, o, do, lse, **kw)
    prev_err, _each = flash_bwd_err(simt(), want, f"{name}, simt")
    row.update(variant=fa.variant_bwd(q.dtype, D), prev_variant="simt",
               prev_ms=cuda_ms(simt, iters=20),
               prev_device_ms=device_ms(simt)[0], prev_max_abs_err=prev_err)
    log(f"[train] {name} variant {row['variant']}; the SIMT "
        f"backward on the same inputs {row['prev_ms']:.4f} ms (device "
        f"{row['prev_device_ms']:.4f} ms, max_abs_err {prev_err:.6g}); "
        f"SDPA's backward device {row['library_device_ms']:.4f} ms")
    return row


def profile_step(label: str, fn, top: int = 8, export: bool = False) -> dict:
    """One call of ``fn`` under ``torch.profiler`` after a warm call: the
    device's busy share of the call's wall time (profiler on) and the
    kernels that took the most device time; with ``export``, the
    profile's chrome export read back (:func:`read_profile_export`).
    Returns the wall and busy seconds and each kernel's device seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    log(f"[profile] {label}: wall {wall * 1e3:.2f} ms (profiler on), "
        f"device busy {busy * 1e3:.2f} ms = {busy / wall:.1%}, "
        f"{sum(e.count for e in kern)} kernel launches")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    if export:
        top5 = [e.key for e in sorted(
            kern, key=lambda e: -e.self_device_time_total)[:5]]
        read_profile_export(label, prof, top5)
    return {"wall_s": wall, "busy_s": busy,
            "kernels": {e.key: e.self_device_time_total / 1e6 for e in kern}}


def read_profile_export(label: str, prof, top5) -> None:
    """``prof``'s ``export_chrome_trace`` opened by the port's chrome reader
    on the card (``on_error="skip"``: a ``torch.profiler`` export holds
    events whose tid is a string): ``flat_profile`` must name each of the
    ``top5`` kernels, and the ``ac2g`` flows (kernel launch to kernel)
    read as ``MpiSend`` / ``MpiRecv`` rows."""
    import tempfile

    from repro_torch import Trace
    from repro_torch.core.constants import MPI_RECV, MPI_SEND, NAME
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"{label}.json")
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        t = Trace.open(path, on_error="skip", device="cuda")
        fp = t.flat_profile()
        read_s = time.perf_counter() - t0
    names = set(np.asarray(fp[NAME]).astype(str))
    col = t.events.column(NAME)
    rows = (col.categories.astype(str)[col.codes] if hasattr(col, "codes")
            else np.asarray(col).astype(str))
    log(f"[profile] {label} export: {size / 1e6:.2f} MB, {len(t)} rows on "
        f"{t.num_processes} processes, {t.ingest_report().total_skipped()} "
        f"events skipped (string tids), {int((rows == MPI_SEND).sum())} "
        f"MpiSend + {int((rows == MPI_RECV).sum())} MpiRecv rows (ac2g "
        f"flows), read + flat_profile on the card {read_s:.2f} s")
    missing = [k for k in top5 if k not in names]
    if missing:
        raise AssertionError(f"{label} export: flat_profile lacks the "
                             f"kernels {missing}")
    log(f"[profile] {label} export: flat_profile names the five kernels "
        f"with the most device time")


def phase_f32_router():
    """One ``moe_ffn`` call in float32 at the serving model's widths: the
    first wave's 3,488 prefill tokens, d_model 2048, 60 experts top-4 of
    width 1408, weights drawn on the card from seed 2 (std fan_in^-1/2, as
    the model draws them).  float32 takes the unfused route, so the
    ``topk_gating`` kernel is launched once, on its narrow path, and
    ``router_topk`` not at all: counts reset just before, read just
    after."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_ffn
    cfg = get_config(ARCH)
    T, d, E, f = 3488, cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    g = torch.Generator(device="cuda").manual_seed(2)

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            * shape[-2] ** -0.5

    x = torch.randn((T, d), generator=g, device="cuda")
    weights = (draw(d, E), draw(E, d, f), draw(E, d, f), draw(E, f, d))
    rt, tg = kernels.router_topk, kernels.topk_gating
    rt.LAUNCHES = tg.LAUNCHES = 0
    rt.VARIANT_CALLS.update(dict.fromkeys(rt.VARIANT_CALLS, 0))
    tg.PATH_LAUNCHES.update(dict.fromkeys(tg.PATH_LAUNCHES, 0))
    with DeviceTimer((tg,)) as timer:
        y = moe_ffn(x, *weights, topk=cfg.topk,
                    capacity_factor=cfg.capacity_factor,
                    groups=cfg.moe_groups)
    torch.cuda.synchronize()
    launches = {"topk_gating": tg.LAUNCHES, "router_topk": rt.LAUNCHES}
    if launches != {"topk_gating": 1, "router_topk": 0} or \
            rt.VARIANT_CALLS != {"fused": 0, "unfused": 1} or \
            tg.PATH_LAUNCHES != {"narrow": 1, "wide": 0}:
        raise AssertionError(f"f32 routing: launches {launches}, calls "
                             f"{rt.VARIANT_CALLS}, topk_gating by path "
                             f"{tg.PATH_LAUNCHES}")
    if y.shape != x.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError("f32 moe_ffn: wrong shape or non-finite")
    log(f"[f32] moe_ffn float32 [{T}, {d}], {E} experts top-{cfg.topk}: "
        f"launches {json.dumps(launches)}, topk_gating by path "
        f"{json.dumps(tg.PATH_LAUNCHES)}, finite output")
    inputs = timer.inputs
    del x, weights, y
    torch.cuda.empty_cache()
    return launches, inputs


def phase_path(arch: str = ARCH, overrides=None) -> None:
    """The smoke config of ``arch`` (with ``overrides``) served on the
    card and on the CPU through the same engine code and weights: the
    same greedy tokens, prefill logits within 1e-3 (f32; cuBLAS vs CPU
    matmuls and the kernels' summation order).  On the card each kernel
    of the family's path launches (flash attention unless the model is
    attention-free, ``topk_gating`` for MoE routing in f32), on the CPU
    none."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention, topk_gating
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = dataclasses.replace(get_smoke_config(arch), **(overrides or {}))
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    extras = model_extras(cfg, 4, "cpu", torch.float32)
    path = [m for m, on in ((flash_attention, cfg.family != "ssm"),
                            (topk_gating, bool(cfg.n_experts))) if on]
    out = {}
    for dev in ("cuda", "cpu"):
        logits = []
        eng = ServeEngine(cfg, batch=4, cache_len=128, params=params,
                          device=dev)
        eng.logits_hook = (lambda ph, lg, _l=logits:
                           _l.append(lg.float().cpu()) if ph == "prefill"
                           else None)
        flash_attention.LAUNCHES = topk_gating.LAUNCHES = 0
        done = eng.serve_queue(make_requests(cfg.vocab, 8, 32, 16),
                               **{k: v.to(dev) for k, v in extras.items()})
        after = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES
                 for m in (flash_attention, topk_gating)}
        want_on = (dev == "cuda")
        if not all((m.LAUNCHES > 0) == want_on for m in path) or any(
                m.LAUNCHES for m in (flash_attention, topk_gating)
                if m not in path):
            raise AssertionError(f"{cfg.name} on {dev}: kernel launches "
                                 f"{after}")
        out[dev] = ([r.out_tokens for r in done], torch.cat(logits))
    (tok_card, lg_card), (tok_cpu, lg_cpu) = out["cuda"], out["cpu"]
    if tok_card != tok_cpu:
        raise AssertionError(f"{cfg.name}: greedy tokens differ between "
                             f"card and CPU")
    err = float((lg_card - lg_cpu).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"{cfg.name}: prefill logits differ by {err}")
    log(f"[path] {cfg.name} f32: {sum(map(len, tok_card))} greedy tokens "
        f"identical on the card and the CPU; prefill logits max abs err "
        f"{err:.3g} (tol 1e-3)")


# ---------------------------------------------------------------------------
# phase 23: gemma3-27b, hymba-1.5b and mamba2-130m served at full width
# ---------------------------------------------------------------------------

#: each family's serving run through ``launch.serve``: bf16 weights drawn on
#: the card from seed 0, full depth and width.  gemma3's one wave pads past
#: its 1,024-key window (the local layers' rings roll); hymba's waves stay
#: under 1,151 positions, where its 128 meta positions sit in the ring
FAMILIES = (
    dict(arch="gemma3-27b", requests=4, batch=4, prompt_len=2048,
         new_tokens=16, cache_len=4096, dtype="bfloat16"),
    dict(arch="hymba-1.5b", requests=8, batch=4, prompt_len=1024,
         new_tokens=16, cache_len=2048, dtype="bfloat16"),
    dict(arch="mamba2-130m", requests=8, batch=4, prompt_len=1024,
         new_tokens=16, cache_len=2048, dtype="bfloat16"),
)
#: the bf16 decode against ``LM.forward`` over the same tokens: within this
#: many times the bf16 forward's own error against an f32 forward of the
#: same weights (the bf16 noise floor of the model at that position).  The
#: decode and the forward round at different places (ring or plain decode
#: attention in f32 against the flash kernel's bf16 P; one-token matmuls
#: against the sequence's), so each alone is about as far from the f32
#: forward as the other, and their difference up to twice that
FAMILY_NOISE_FACTOR = 3.0
#: the same decode in f32 at full width (hymba-1.5b and mamba2-130m fit
#: the card in f32; gemma3-27b's 108 GB do not): within this share of the
#: forward's largest |logit|, where bf16 noise no longer hides a fault
FAMILY_F32_TOL = 2e-3
#: the families also served in f32 (one wave) for that check
FAMILIES_F32 = ("hymba-1.5b", "mamba2-130m")


def _layers_f32(x, layers, cfg, enc_out=None):
    """``x`` through ``layers`` in f32, each layer's weights cast to f32
    only while it runs."""
    from repro_torch.models.blocks import layer_apply
    for blk in layers:
        p = {k: v.float() for k, v in blk._parameters.items()}
        x, _ = layer_apply(p, x, cfg, blk.spec, mode="train",
                           enc_out=enc_out)
        del p
    return x


@torch.no_grad()
def forward_f32(model, tokens: torch.Tensor, last: int,
                extras=None) -> torch.Tensor:
    """The model's forward over ``tokens`` [1, T] (with its ``extras``:
    frames or image embeddings of batch 1) in f32 with its weights cast
    to f32 one layer at a time (a 27 B-parameter model does not fit the
    card twice): logits of the last ``last`` positions [last, vocab], the
    unembedding in vocabulary blocks.  The f32 flash kernel serves its
    attention."""
    from repro_torch.models.encdec import sinusoidal_positions
    from repro_torch.models.layers import rms_norm
    cfg = model.cfg
    extras = extras or {}
    enc_out = None
    if "frames" in extras:                     # the encoder, as encode()
        frames = extras["frames"].float()
        e = frames @ model.frontend.float()
        e = e + torch.from_numpy(sinusoidal_positions(
            frames.shape[1], cfg.d_model)).to(e.device)[None]
        e = _layers_f32(e, model.enc_layers, cfg)
        enc_out = rms_norm(e, model.enc_ln.float(), cfg.norm_eps)
    x, _prefix = model._embed_tokens(tokens, extras.get("img_embeds"))
    x = _layers_f32(x.float(), model.layers, cfg, enc_out)
    x = rms_norm(x[0, -last:], model.final_ln.float(), cfg.norm_eps)
    w = model.embed if cfg.tie_embeddings else model.unembed.T
    return torch.cat([x @ w[i:i + 32768, :].float().T
                      for i in range(0, cfg.vocab, 32768)], dim=1)[
                          :, :cfg.vocab]


def _serve_family(spec: dict, extras=None, timer_mods=()) -> tuple:
    """One serving run of ``spec`` through ``launch.serve`` on the card
    (``extras`` to every wave's prefill), counts reset just before and
    read just after; returns (run, the first wave's decode logits of its
    first request, launches, by variant, peak, wall s, the first call's
    inputs of each module of ``timer_mods``)."""
    from repro_torch import kernels
    from repro_torch.launch import serve as launch
    fa = kernels.flash_attention
    decodes, finite = [], []

    def hook(phase, logits):
        finite.append(torch.isfinite(logits).all())
        if phase == "decode":
            decodes.append(logits[0].clone())     # the wave's first request

    torch.cuda.synchronize()
    reset_peak()
    for mod in kernels.MODEL_KERNELS:
        mod.LAUNCHES = 0
    fa.VARIANT_LAUNCHES.update(dict.fromkeys(fa.VARIANT_LAUNCHES, 0))
    t0 = time.perf_counter()
    with DeviceTimer(timer_mods) as timer:
        run = launch.serve(**spec, device="cuda", logits_hook=hook,
                           extras=extras)
    wall = time.perf_counter() - t0
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in kernels.MODEL_KERNELS}
    cfg = run.engine.cfg
    new = spec["new_tokens"]
    if len(run.done) != spec["requests"] or any(
            len(r.out_tokens) != new for r in run.done) or any(
            not 0 <= t < cfg.vocab for r in run.done for t in r.out_tokens):
        raise AssertionError(f"{cfg.name}: tokens missing or outside the "
                             f"vocabulary")
    if not finite or not all(bool(f) for f in finite):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return (run, decodes[:new - 1], launches, dict(fa.VARIANT_LAUNCHES),
            torch.cuda.max_memory_allocated(), wall, timer.inputs)


def _decode_against_forward(tag, run, decodes, batch, new, ref: bool,
                            extras=None):
    """The first request's greedy tokens and last decode step against
    ``LM.forward`` over its padded prompt and the tokens fed (and its row
    of the wave's ``extras``).  Returns
    (err, the chosen tokens' largest shortfall below the forward's best,
    tokens equal to the forward's argmax, max |logit|, the bf16 forward's
    error against :func:`forward_f32` or None)."""
    model, cfg = run.engine.model, run.engine.cfg
    wave = first_wave(run.done, batch)
    req = run.done[0]
    seq = torch.from_numpy(np.concatenate(
        [wave[0], np.asarray(req.out_tokens[:-1])])[None]).cuda()
    first = {k: v[:1] for k, v in (extras or {}).items()}
    logits, prefix = model.forward(seq, **first)
    fw = logits[0, prefix + wave.shape[1] - 1:, :cfg.vocab].float()
    del logits
    last = decodes[-1][:cfg.vocab].float()
    err = float((last - fw[-1]).abs().max())
    idx = torch.tensor(req.out_tokens, device=fw.device)
    behind = float((fw.max(dim=-1).values -
                    fw[torch.arange(new, device=fw.device), idx]).max())
    agree = int((fw.argmax(dim=-1) == idx).sum())
    floor = None
    if ref:
        exact_fw = forward_f32(model, seq, 1, first)[0]
        floor = float((fw[-1] - exact_fw).abs().max())
        log(f"{tag} against the f32 forward of the same weights: the bf16 "
            f"forward {floor:.4g}, the bf16 decode "
            f"{float((last - exact_fw).abs().max()):.4g} (max abs)")
    return err, behind, agree, float(fw[-1].abs().max()), floor


def phase_families() -> dict:
    """Each of :data:`FAMILIES` through ``launch.serve`` on the card in
    bf16: counts reset just before and read just after (flash attention
    one launch a layer with attention a wave, every launch on the
    tensor-core variant, none for mamba2; no router kernel); every
    request its tokens, in the vocabulary, finite logits; the trace's
    spans; the waves' padded lengths and decode positions; the first
    request's last decode step against ``LM.forward`` on its padded
    prompt and the tokens fed, within :data:`FAMILY_NOISE_FACTOR` times
    the bf16 forward's own error against :func:`forward_f32`, and each
    greedy token the forward's argmax up to a tie within that; a decode
    step profiled.  Then :data:`FAMILIES_F32` served again in f32 (one
    wave), the decode against the f32 forward within
    :data:`FAMILY_F32_TOL` of its largest |logit|; then the smoke config
    on the card and on the CPU (:func:`phase_path`).  Returns, per
    family, its launches."""
    from repro_torch.core.constants import INC
    out = {}
    for spec in FAMILIES:
        arch = spec["arch"]
        run, decodes, launches, by_variant, peak, wall, _ = _serve_family(
            spec)
        cfg, model = run.engine.cfg, run.engine.model
        tag = f"[family] {cfg.name}:"
        attn_layers = sum(s.mixer != "ssm" for s in model.specs)
        batch, new = spec["batch"], spec["new_tokens"]
        waves = [run.done[i:i + batch]
                 for i in range(0, len(run.done), batch)]
        pads = [max(len(r.prompt) for r in w) for w in waves]
        starts = [p + cfg.meta_tokens for p in pads]   # first decode pos
        log(f"{tag} {cfg.n_layers} layers ({attn_layers} with attention), "
            f"d_model {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B "
            f"parameters in {spec['dtype']}, window {cfg.window}, meta "
            f"tokens {cfg.meta_tokens}; served {len(run.done)} requests "
            f"in {len(waves)} waves in {wall:.2f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB")
        log(f"{tag} waves padded to {pads} prompt tokens; decode positions "
            + ", ".join(f"{s}-{s + new - 2}" for s in starts))
        log(f"{tag} launches {json.dumps(launches)}; flash_attention by "
            f"variant {json.dumps(by_variant)}")
        want = attn_layers * len(waves)          # one launch a layer a wave
        if launches["flash_attention"] != want or \
                by_variant["wgmma"] != want or \
                launches["router_topk"] or launches["topk_gating"]:
            raise AssertionError(f"{tag} launches {launches}, by variant "
                                 f"{by_variant}; expected {want} flash "
                                 f"launches, all wgmma, no router")
        if cfg.window and cfg.global_every and not max(pads) > cfg.window:
            raise AssertionError(f"{tag} no wave pads past the window "
                                 f"{cfg.window}: the rings never roll")
        if cfg.meta_tokens and not min(starts) < \
                cfg.window + cfg.meta_tokens - 1:
            raise AssertionError(f"{tag} no decode position below "
                                 f"{cfg.window + cfg.meta_tokens - 1}: "
                                 f"the meta positions leave the ring first")
        trace = run.tracer.to_trace(device="cuda")
        fp = trace.flat_profile(metrics=(INC,))
        prof = {n: (int(c), float(t)) for n, c, t in
                zip(fp["Name"], fp["count"], fp[INC])}
        if prof.get("prefill", (0,))[0] != len(waves) or prof.get(
                "decode_step", (0,))[0] != len(waves) * (new - 1):
            raise AssertionError(f"{tag} span counts {prof}")
        step_ms = prof["decode_step"][1] / 1e6 / (len(waves) * (new - 1))
        log(f"{tag} prefill {prof['prefill'][1] / 1e9 / len(waves):.4f} s "
            f"a wave; decode {step_ms:.3f} ms a step; "
            f"{run.summary['tok_per_s']} tok/s (beside the trace half)")
        err, behind, agree, scale, floor = _decode_against_forward(
            tag, run, decodes, batch, new, ref=True)
        tol = FAMILY_NOISE_FACTOR * floor
        log(f"{tag} request 0 (padded to {pads[0]}): last decode step "
            f"against LM.forward max abs err {err:.4g} (tol {tol:.4g} = "
            f"{FAMILY_NOISE_FACTOR:g} x the bf16 forward's own error; max "
            f"|logit| {scale:.4g}); greedy tokens the forward's argmax "
            f"{agree}/{new}, the chosen token at most {behind:.4g} below "
            f"the forward's best")
        if not (err <= tol and behind <= tol):
            raise AssertionError(f"{tag} bf16 decode against the forward: "
                                 f"err {err}, chosen token {behind} below "
                                 f"the best, tolerance {tol}")
        profile_serving(model, spec, first_wave(run.done, batch),
                        prefill=False)
        del run, model, trace, decodes
        torch.cuda.empty_cache()
        if arch in FAMILIES_F32:
            f32 = dict(spec, dtype="float32", requests=batch)
            run, decodes, launches32, *_ = _serve_family(f32)
            err, behind, agree, scale, _f = _decode_against_forward(
                tag, run, decodes, batch, new, ref=False)
            tol = FAMILY_F32_TOL * scale
            log(f"{tag} f32, one wave: last decode step against LM.forward "
                f"max abs err {err:.4g} (tol {tol:.4g} = {FAMILY_F32_TOL:g} "
                f"x max |logit| {scale:.4g}); greedy tokens the forward's "
                f"argmax {agree}/{new}, the chosen token at most "
                f"{behind:.4g} below the forward's best; flash launches "
                f"{launches32['flash_attention']} (SIMT, f32)")
            if not (err <= tol and behind <= tol):
                raise AssertionError(f"{tag} f32 decode against the "
                                     f"forward: err {err}, chosen token "
                                     f"{behind} below, tolerance {tol}")
            del run, decodes
            torch.cuda.empty_cache()
        out[arch] = {"launches": launches}
        phase_path(arch)
    return out


# ---------------------------------------------------------------------------
# phase 24: whisper-medium, phi-3-vision-4.2b, codeqwen1.5-7b, qwen1.5-0.5b
# ---------------------------------------------------------------------------

#: each model's serving run through ``launch.serve``: bf16 weights drawn on
#: the card from seed 0, full depth and width; whisper's prompts up to its
#: published decoder context of 448 tokens, the others' up to 1,024
ENCDEC = (
    dict(arch="whisper-medium", requests=8, batch=4, prompt_len=448,
         new_tokens=16, cache_len=512, dtype="bfloat16"),
    dict(arch="phi-3-vision-4.2b", requests=8, batch=4, prompt_len=1024,
         new_tokens=16, cache_len=2048, dtype="bfloat16"),
    dict(arch="codeqwen1.5-7b", requests=8, batch=4, prompt_len=1024,
         new_tokens=16, cache_len=2048, dtype="bfloat16"),
    dict(arch="qwen1.5-0.5b", requests=8, batch=4, prompt_len=1024,
         new_tokens=16, cache_len=2048, dtype="bfloat16"),
)


def model_extras(cfg, batch: int, device, dtype, seed: int = 0) -> dict:
    """The model's extra inputs as seeded standard-normal draws on
    ``device``: ``frames`` [batch, enc_frames, d_model] for the
    encoder-decoder, ``img_embeds`` [batch, img_tokens, d_model] for a
    model with image tokens; {} for the rest."""
    if cfg.family == "encdec":
        name, rows = "frames", cfg.enc_frames
    elif cfg.img_tokens:
        name, rows = "img_embeds", cfg.img_tokens
    else:
        return {}
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: torch.randn((batch, rows, cfg.d_model), generator=gen,
                              device=device).to(dtype)}


def flash_launches(cfg, waves: int, new: int) -> int:
    """Flash launches of a serving run: one a layer with attention a wave;
    the encoder-decoder adds its encoder's layers and its cross-attention,
    once a decoder layer in prefill and in each of the ``new - 1`` decode
    steps."""
    if cfg.family == "encdec":
        return waves * (cfg.enc_layers + cfg.n_layers * (1 + new))
    return waves * cfg.n_layers


def phase_encdec() -> dict:
    """Each of :data:`ENCDEC` through ``launch.serve`` on the card in bf16
    with its extras (:func:`model_extras`, batch 4, the same for both
    waves): counts reset just before and read just after (flash
    :func:`flash_launches`, all ``"wgmma"``, phi-3-vision's head dim 96
    too; no router kernel);
    every request its tokens, in the vocabulary, finite logits; the
    trace's spans; the first request's last decode step against
    ``forward`` on its padded prompt, the tokens fed and its row of the
    extras, within :data:`FAMILY_NOISE_FACTOR` times the bf16 forward's
    own error against :func:`forward_f32`, each greedy token the
    forward's argmax up to a tie within that; one prefill wave and one
    decode step profiled (busy share, flash's share of the prefill); the
    smoke config on the card and on the CPU (:func:`phase_path`).
    Returns, per model, its launches and variant, and phi-3-vision's
    first flash call's inputs (head dim 96) for its timing row."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.constants import INC
    fa = kernels.flash_attention
    out = {}
    for spec in ENCDEC:
        arch = spec["arch"]
        cfg = get_config(arch)
        batch, new = spec["batch"], spec["new_tokens"]
        extras = model_extras(cfg, batch, "cuda", torch.bfloat16)
        run, decodes, launches, by_variant, peak, wall, inputs = \
            _serve_family(spec, extras, timer_mods=(fa,))
        model = run.engine.model
        tag = f"[encdec] {cfg.name}:"
        waves = [run.done[i:i + batch]
                 for i in range(0, len(run.done), batch)]
        pads = [max(len(r.prompt) for r in w) for w in waves]
        starts = [p + cfg.img_tokens for p in pads]    # first decode pos
        n_params = sum(t.numel() for t in model.state_dict().values())
        log(f"{tag} {cfg.n_layers} layers (+ {cfg.enc_layers} encoder "
            f"layers over {cfg.enc_frames} frames)" if cfg.enc_layers else
            f"{tag} {cfg.n_layers} layers", f"d_model {cfg.d_model}, "
            f"{cfg.n_heads} x {cfg.hd} heads over {cfg.n_kv_heads}, act "
            f"{cfg.act}, image tokens {cfg.img_tokens}, "
            f"{n_params / 1e9:.3f} B parameters in {spec['dtype']} (config "
            f"count {cfg.param_count() / 1e9:.3f} B); extras "
            f"{ {k: list(v.shape) for k, v in extras.items()} }; served "
            f"{len(run.done)} requests in {len(waves)} waves in {wall:.2f} "
            f"s, peak device memory {peak / 2**30:.2f} GiB")
        log(f"{tag} waves padded to {pads} prompt tokens; decode positions "
            + ", ".join(f"{s}-{s + new - 2}" for s in starts))
        log(f"{tag} launches {json.dumps(launches)}; flash_attention by "
            f"variant {json.dumps(by_variant)}")
        want = flash_launches(cfg, len(waves), new)
        variant = fa.variant(torch.bfloat16, cfg.hd)
        if launches["flash_attention"] != want or \
                by_variant[variant] != want or \
                launches["router_topk"] or launches["topk_gating"]:
            raise AssertionError(f"{tag} launches {launches}, by variant "
                                 f"{by_variant}; expected {want} flash "
                                 f"launches, all {variant}, no router")
        trace = run.tracer.to_trace(device="cuda")
        fp = trace.flat_profile(metrics=(INC,))
        prof = {n: (int(c), float(t)) for n, c, t in
                zip(fp["Name"], fp["count"], fp[INC])}
        if prof.get("prefill", (0,))[0] != len(waves) or prof.get(
                "decode_step", (0,))[0] != len(waves) * (new - 1):
            raise AssertionError(f"{tag} span counts {prof}")
        step_ms = prof["decode_step"][1] / 1e6 / (len(waves) * (new - 1))
        log(f"{tag} prefill {prof['prefill'][1] / 1e9 / len(waves):.4f} s "
            f"a wave; decode {step_ms:.3f} ms a step; "
            f"{run.summary['tok_per_s']} tok/s (beside the trace half)")
        err, behind, agree, scale, floor = _decode_against_forward(
            tag, run, decodes, batch, new, ref=True, extras=extras)
        tol = FAMILY_NOISE_FACTOR * floor
        log(f"{tag} request 0 (padded to {pads[0]}): last decode step "
            f"against forward max abs err {err:.4g} (tol {tol:.4g} = "
            f"{FAMILY_NOISE_FACTOR:g} x the bf16 forward's own error; max "
            f"|logit| {scale:.4g}); greedy tokens the forward's argmax "
            f"{agree}/{new}, the chosen token at most {behind:.4g} below "
            f"the forward's best")
        if not (err <= tol and behind <= tol):
            raise AssertionError(f"{tag} bf16 decode against the forward: "
                                 f"err {err}, chosen token {behind} below "
                                 f"the best, tolerance {tol}")
        profiles = profile_serving(model, spec, first_wave(run.done, batch),
                                   extras=extras)
        for phase, p in profiles.items():
            flash = sum(t for k, t in p["kernels"].items() if "flash_" in k)
            busy, wall_s = p["busy_s"], p["wall_s"]
            log(f"{tag} profiled {phase}: flash kernels {flash * 1e3:.3f} "
                f"ms = {flash / busy:.1%} of the device's busy "
                f"{busy * 1e3:.3f} ms, busy {busy / wall_s:.1%} of the "
                f"wall {wall_s * 1e3:.2f} ms")
        out[arch] = {"launches": launches, "variant": variant}
        if cfg.hd == 96:
            out[arch]["flash_inputs"] = inputs["flash_attention"]
        del run, model, trace, decodes, extras, inputs
        torch.cuda.empty_cache()
        phase_path(arch)
    return out


# ---------------------------------------------------------------------------
# phase 25: qwen1.5-110b and qwen3-moe-235b-a22b at full width, depth cut;
# qwen1.5-110b's prefill and decode cells on a (1, 1) NCCL mesh
# ---------------------------------------------------------------------------

#: the two configs no single card holds, served at full width in bf16 from
#: seed 0 with their depth cut to 8 layers: qwen1.5-110b's 80 layers are
#: 222.4 GB, its 8 are 13.363 B parameters (26.7 GB); qwen3-moe-235b-a22b's
#: 94 are 470.2 GB, its 8 are 21.148 B (42.3 GB; 128 experts top-8).
#: qwen3-moe is served dropless (capacity factor E / k = 16: an expert's
#: capacity is its group's token count), as the published model routes
#: every token: at the configs' default 1.25 the random router overflows
#: experts, the wave's prefill and a sequence's forward drop different
#: tokens, and decode (always dropless) cannot be held to the forward.
#: Dropless, every expert multiplies all of a wave's tokens, 16 times the
#: assignments: prefill_at_capacity times the first wave at 1.25 as well
GIANTS = (
    dict(arch="qwen1.5-110b", overrides={"n_layers": 8}, requests=8,
         batch=4, prompt_len=1024, new_tokens=16, cache_len=2048,
         dtype="bfloat16"),
    dict(arch="qwen3-moe-235b-a22b",
         overrides={"n_layers": 8, "capacity_factor": 16.0}, requests=8,
         batch=4, prompt_len=1024, new_tokens=16, cache_len=2048,
         dtype="bfloat16"),
)
#: the model served again through build_cell's cells on a (1, 1) mesh
SHARDED_ARCH = "qwen1.5-110b"


def phase_giants() -> dict:
    """Each of :data:`GIANTS` through ``launch.serve`` on the card in bf16,
    its cut logged with its reason: counts reset just before and read
    just after (flash one launch a layer a wave, all ``"wgmma"``;
    qwen3-moe's router one ``router_topk`` launch a layer a prefill and
    a decode step, every call on the ``"fused"`` route, no
    ``topk_gating``; none for the dense model); every request its tokens,
    in the vocabulary, finite logits; the trace's spans; the first
    request's last decode step against ``forward`` within
    :data:`FAMILY_NOISE_FACTOR` times the bf16 forward's own error
    against :func:`forward_f32`, each greedy token the forward's argmax up
    to a tie within that; one prefill wave and one decode step profiled
    (busy share); qwen3-moe's first wave at its published capacity factor
    (:func:`prefill_at_capacity`).  Then :data:`SHARDED_ARCH`'s loaded
    model through :func:`phase_sharded`, and the smoke config on the card
    and on the CPU (:func:`phase_path`; qwen1.5-110b-smoke with its 8-wide
    heads doubled to the flash kernel's smallest, 16).  Returns, per
    model, its launches, routes and the first flash (and router) call's
    inputs for the timing rows, qwen3-moe's prefill ms by capacity factor,
    and the sharded run's."""
    from repro_torch import kernels
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.constants import INC
    fa, rt = kernels.flash_attention, kernels.router_topk
    out = {}
    for spec in GIANTS:
        arch = spec["arch"]
        full = get_config(arch)
        cfg = dataclasses.replace(full, **spec["overrides"])
        batch, new = spec["batch"], spec["new_tokens"]
        tag = f"[giant] {cfg.name}:"
        experts = (f", {cfg.n_experts} experts top-{cfg.topk} of width "
                   f"{cfg.moe_d_ff}, capacity factor {cfg.capacity_factor:g} "
                   f"(dropless)" if cfg.n_experts else "")
        log(f"{tag} cut: {full.n_layers} -> {cfg.n_layers} layers at full "
            f"width (d_model {cfg.d_model}, {cfg.n_heads} x {cfg.hd} heads "
            f"over {cfg.n_kv_heads} KV heads, vocab {cfg.vocab}{experts}): "
            f"{full.n_layers} layers are {full.param_count() * 2 / 1e9:.1f} "
            f"GB in bf16, more than the card's 80 GB; "
            f"{cfg.param_count() / 1e9:.3f} B parameters "
            f"({cfg.param_count() * 2 / 1e9:.1f} GB) kept")
        rt.VARIANT_CALLS.update(dict.fromkeys(rt.VARIANT_CALLS, 0))
        run, decodes, launches, by_variant, peak, wall, inputs = \
            _serve_family(spec, timer_mods=(fa, rt))
        routes = dict(rt.VARIANT_CALLS)
        model = run.engine.model
        waves = [run.done[i:i + batch]
                 for i in range(0, len(run.done), batch)]
        pads = [max(len(r.prompt) for r in w) for w in waves]
        n_params = sum(t.numel() for t in model.state_dict().values())
        log(f"{tag} {n_params / 1e9:.3f} B parameters in {spec['dtype']}; "
            f"served {len(run.done)} requests in {len(waves)} waves "
            f"(padded to {pads}) in {wall:.2f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB")
        log(f"{tag} launches {json.dumps(launches)}; flash_attention by "
            f"variant {json.dumps(by_variant)}; router_topk by route "
            f"{json.dumps(routes)}")
        want = len(waves) * cfg.n_layers
        router = len(waves) * cfg.n_layers * new if cfg.n_experts else 0
        if launches["flash_attention"] != want or \
                by_variant["wgmma"] != want or \
                launches["router_topk"] != router or \
                routes != {"fused": router, "unfused": 0} or \
                launches["topk_gating"]:
            raise AssertionError(f"{tag} launches {launches}, by variant "
                                 f"{by_variant}, routes {routes}; expected "
                                 f"{want} flash launches, all wgmma, "
                                 f"{router} fused router launches")
        trace = run.tracer.to_trace(device="cuda")
        fp = trace.flat_profile(metrics=(INC,))
        prof = {n: (int(c), float(t)) for n, c, t in
                zip(fp["Name"], fp["count"], fp[INC])}
        if prof.get("prefill", (0,))[0] != len(waves) or prof.get(
                "decode_step", (0,))[0] != len(waves) * (new - 1):
            raise AssertionError(f"{tag} span counts {prof}")
        step_ms = prof["decode_step"][1] / 1e6 / (len(waves) * (new - 1))
        log(f"{tag} prefill {prof['prefill'][1] / 1e9 / len(waves):.4f} s "
            f"a wave; decode {step_ms:.3f} ms a step; "
            f"{run.summary['tok_per_s']} tok/s (beside the trace half)")
        err, behind, agree, scale, floor = _decode_against_forward(
            tag, run, decodes, batch, new, ref=True)
        tol = FAMILY_NOISE_FACTOR * floor
        log(f"{tag} request 0 (padded to {pads[0]}): last decode step "
            f"against forward max abs err {err:.4g} (tol {tol:.4g} = "
            f"{FAMILY_NOISE_FACTOR:g} x the bf16 forward's own error; max "
            f"|logit| {scale:.4g}); greedy tokens the forward's argmax "
            f"{agree}/{new}, the chosen token at most {behind:.4g} below "
            f"the forward's best")
        if not (err <= tol and behind <= tol):
            raise AssertionError(f"{tag} bf16 decode against the forward: "
                                 f"err {err}, chosen token {behind} below "
                                 f"the best, tolerance {tol}")
        profiles = profile_serving(model, spec, first_wave(run.done, batch))
        for phase, p in profiles.items():
            busy, wall_s = p["busy_s"], p["wall_s"]
            log(f"{tag} profiled {phase}: busy {busy * 1e3:.3f} ms = "
                f"{busy / wall_s:.1%} of the wall {wall_s * 1e3:.2f} ms")
        out[arch] = {"launches": launches, "routes": routes,
                     "flash_inputs": inputs["flash_attention"]}
        if cfg.n_experts:
            out[arch]["router_inputs"] = inputs["router_topk"]
            out[arch]["capacity"] = prefill_at_capacity(
                model, spec, first_wave(run.done, batch),
                full.capacity_factor, tag)
        if arch == SHARDED_ARCH:
            out["sharded"] = phase_sharded(run, spec)
        del run, model, trace, decodes, inputs
        torch.cuda.empty_cache()
        smoke = get_smoke_config(arch)
        if smoke.hd < 16:
            # qwen1.5-110b-smoke's heads are 8 wide, below the flash
            # kernel's smallest head dim (16): its width doubled there
            log(f"{tag} smoke config served with head_dim 16 (its own "
                f"{smoke.hd} is below the flash kernel's smallest)")
        phase_path(arch, {"head_dim": 16} if smoke.hd < 16 else None)
    return out


def prefill_at_capacity(model, spec: dict, wave: np.ndarray, factor: float,
                        tag: str) -> dict:
    """The served MoE ``model`` on one prefill ``wave`` at its served
    (dropless) capacity factor and at ``factor``, the published config's,
    where the dispatch drops the assignments that overflow an expert: for
    each, the slots an expert gets, the prefill's ms (CUDA events, mean of
    3 after a warm call), finite logits and one fused ``router_topk``
    launch a layer; the published factor's prefill profiled (busy share,
    top kernels).  No decode is held to a forward here: at ``factor`` a
    wave's prefill and a sequence's forward drop different assignments.
    The model's config is restored after.  Returns the ms by factor."""
    from repro_torch.kernels import router_topk as rt
    from repro_torch.models.lm import Block
    from repro_torch.models.moe import capacity
    served = model.cfg
    holders = [model] + [m for m in model.modules() if isinstance(m, Block)]
    tokens = torch.from_numpy(wave).cuda()
    T = tokens.numel()
    step = lambda: model.prefill(tokens, spec["cache_len"])  # noqa: E731
    out = {}
    try:
        for f in (served.capacity_factor, factor):
            cfg = dataclasses.replace(served, capacity_factor=f)
            for m in holders:
                m.cfg = cfg
            C = capacity(T // cfg.moe_groups, cfg.topk, cfg.n_experts, f,
                         False)
            before = dict(rt.VARIANT_CALLS)
            _cache, logits, _pos = step()
            fused = rt.VARIANT_CALLS["fused"] - before["fused"]
            if not bool(torch.isfinite(logits).all()) or \
                    fused != cfg.n_layers or \
                    rt.VARIANT_CALLS["unfused"] != before["unfused"]:
                raise AssertionError(f"{tag} prefill at capacity factor "
                                     f"{f:g}: finite logits, {fused} fused "
                                     f"router calls of {cfg.n_layers}")
            del _cache, logits
            ms = cuda_ms(step, iters=3, warm=1)
            out[f] = ms
            log(f"{tag} prefill of wave [{wave.shape[0]}, {wave.shape[1]}] "
                f"at capacity factor {f:g}: {C} slots an expert, "
                f"{C * cfg.n_experts / (T * cfg.topk):.3g} x the wave's "
                f"{T * cfg.topk} assignments; {ms:.3f} ms (CUDA events, "
                f"mean of 3); logits finite, {fused} fused router launches")
            if f == factor:
                profile_step(f"{cfg.name} prefill at capacity factor {f:g}",
                             step)
            torch.cuda.empty_cache()
    finally:
        for m in holders:
            m.cfg = served
    return out


def phase_sharded(run, spec: dict) -> dict:
    """The served model of ``run`` (its parameters placed as DTensors
    without a copy) through ``launch.steps.build_cell``'s prefill and
    decode cells on a (data 1, model 1) NCCL mesh, world size 1, on the
    first wave's requests (``launch.steps.CellEngine``, the engine's own
    loop over the cells): its greedy tokens equal the engine's, and its
    flash launches the unsharded wave's (one a layer, all ``"wgmma"``).
    Leaves the model sharded."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import CellEngine, build_cell
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serving import Request
    model, cfg = run.engine.model, run.engine.cfg
    batch, new, S = spec["batch"], spec["new_tokens"], spec["cache_len"]
    tag = f"[sharded] {cfg.name}:"
    wave = run.done[:batch]
    want = [r.out_tokens for r in wave]
    shape = first_wave(run.done, batch).shape
    with nccl_world_of_one():
        mesh = make_local_mesh()
        t0 = time.perf_counter()
        pre = build_cell(cfg, ShapeConfig("serve", S, batch, "prefill"),
                         mesh, model=model)
        dec = build_cell(cfg, ShapeConfig("serve", S, batch, "decode"),
                         mesh, model=model)
        t_place = time.perf_counter() - t0
        torch.cuda.synchronize()
        fa.LAUNCHES = 0
        fa.VARIANT_LAUNCHES.update(dict.fromkeys(fa.VARIANT_LAUNCHES, 0))
        t0 = time.perf_counter()
        got = [r.out_tokens for r in CellEngine(pre, dec, batch).generate(
            [Request(r.rid, r.prompt, max_new_tokens=r.max_new_tokens)
             for r in wave])]
        wall = time.perf_counter() - t0
        launches, by_variant = fa.LAUNCHES, dict(fa.VARIANT_LAUNCHES)
        rules = {k: v for k, v in pre.rules.rules}
    log(f"{tag} mesh (data 1, model 1) over NCCL, world size 1; parameters "
        f"placed in {t_place:.2f} s (no copy: peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); "
        f"rules heads {rules['heads']!r}, kv {rules['kv']!r}, embed "
        f"{rules['embed']!r}; one wave [{shape[0]}, "
        f"{shape[1]}] prefilled and decoded {new - 1} steps in "
        f"{wall:.2f} s; flash launches {launches} (by variant "
        f"{json.dumps(by_variant)}) against the unsharded wave's "
        f"{cfg.n_layers}; greedy tokens equal the engine's: {got == want}")
    if got != want:
        raise AssertionError(f"{tag} greedy tokens {got} differ from the "
                             f"unsharded run's {want}")
    if launches != cfg.n_layers or by_variant["wgmma"] != cfg.n_layers:
        raise AssertionError(f"{tag} flash launches {launches} "
                             f"({by_variant}), the unsharded wave's "
                             f"{cfg.n_layers}")
    return {"launches": launches, "tokens_equal": True, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 26: every served family trained at full width, depth cut to fit
# ---------------------------------------------------------------------------

#: each config's train run through ``runtime.Trainer`` on the card: bf16
#: weights drawn from seed 0, batches from ``SyntheticLMStream(seed=1)``,
#: seeded bf16 extras (:func:`model_extras`).  Training holds about 16
#: bytes a parameter (the bf16 weight and its gradient, the f32 gradient,
#: the f32 moments m and v), so the depth is cut where the whole model
#: would not fit: the largest run (gemma3-27b's 6 layers, one period of 5
#: local + 1 global) is 3.887 B parameters, ~62 GB
TRAIN_FAMILIES = (
    dict(arch="qwen2-moe-a2.7b", layers=4, batch=4, seq=512, steps=10),
    dict(arch="qwen3-moe-235b-a22b", layers=1, batch=2, seq=1024, steps=3),
    dict(arch="qwen1.5-110b", layers=1, batch=2, seq=1024, steps=3),
    dict(arch="gemma3-27b", layers=6, batch=1, seq=2048, steps=3),
    dict(arch="hymba-1.5b", layers=None, batch=2, seq=1024, steps=3),
    dict(arch="mamba2-130m", layers=None, batch=4, seq=1024, steps=3),
    dict(arch="whisper-medium", layers=None, batch=2, seq=448, steps=3),
    dict(arch="phi-3-vision-4.2b", layers=16, batch=2, seq=1024, steps=3),
    dict(arch="codeqwen1.5-7b", layers=8, batch=2, seq=1024, steps=3),
    dict(arch="qwen1.5-0.5b", layers=None, batch=4, seq=1024, steps=3),
)
#: the config whose losses must fall over its steps, and which then takes
#: one step through ``launch.steps.build_cell``'s train cell
TRAIN_CELL_ARCH = "qwen2-moe-a2.7b"
#: the learning rate of the phase's runs (one warm-up step, then cosine)
TRAIN_FAMILY_LR = 1e-3
#: bytes a parameter takes in training (see :data:`TRAIN_FAMILIES`)
TRAIN_BYTES_PER_PARAM = 16


def train_family_cfg(spec: dict):
    """The config of ``spec`` at full width, its depth cut where the spec
    says."""
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"])
    if spec["layers"] is not None:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    return cfg


def train_trainer(spec: dict, steps: int):
    """A ``runtime.Trainer`` of ``spec``'s config on the card in bf16,
    drawn from seed 0."""
    from repro_torch.runtime import Trainer, TrainLoopConfig
    return Trainer(train_family_cfg(spec), TrainLoopConfig(
        steps=steps, peak_lr=TRAIN_FAMILY_LR, warmup_steps=1,
        ckpt_every=0, dtype=torch.bfloat16), device="cuda")


def train_batch(cfg, spec: dict, step: int) -> dict:
    """``SyntheticLMStream(seed=1)``'s batch at ``step`` with the config's
    seeded bf16 extras on the card."""
    batch = _train_batch(cfg, spec, step)
    batch.update(model_extras(cfg, spec["batch"], "cuda", torch.bfloat16))
    return batch


def train_flash_per_step(cfg) -> int:
    """Flash forward (and backward) launches of one train step: one a
    layer with attention; the encoder-decoder's encoder layers, decoder
    self-attention and cross-attention; none for an SSM."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def reset_model_counts() -> None:
    from repro_torch import kernels
    fa, rt, tg = (kernels.flash_attention, kernels.router_topk,
                  kernels.topk_gating)
    for mod in kernels.MODEL_KERNELS:
        mod.LAUNCHES = 0
    fa.LAUNCHES_BWD = tg.LAUNCHES_BWD = 0
    for d in (fa.VARIANT_LAUNCHES, fa.VARIANT_LAUNCHES_BWD,
              rt.VARIANT_CALLS, tg.PATH_LAUNCHES):
        d.update(dict.fromkeys(d, 0))


def model_counts() -> dict:
    from repro_torch import kernels
    fa, rt, tg = (kernels.flash_attention, kernels.router_topk,
                  kernels.topk_gating)
    return {"flash_attention": fa.LAUNCHES,
            "flash_attention_bwd": fa.LAUNCHES_BWD,
            "flash_by_variant": dict(fa.VARIANT_LAUNCHES),
            "flash_bwd_by_variant": dict(fa.VARIANT_LAUNCHES_BWD),
            "router_topk": rt.LAUNCHES, "router_calls": dict(rt.VARIANT_CALLS),
            "topk_gating": tg.LAUNCHES, "topk_gating_bwd": tg.LAUNCHES_BWD}


def phase_train_families() -> dict:
    """Each of :data:`TRAIN_FAMILIES` trained through ``runtime.Trainer``
    on the card (:func:`train_family`), then :data:`TRAIN_CELL_ARCH`
    through the train cell on a (1, 1) NCCL mesh (:func:`train_cell`),
    then every config's smoke config in f32 from one seeded weight set, 3
    steps on the card and on the CPU (:func:`train_path`).  Returns, per
    config, its launches and step times, and the first router backward
    call's inputs of each MoE config (the timing rows')."""
    from repro_torch.configs import get_smoke_config
    out = {}
    for spec in TRAIN_FAMILIES:
        out[spec["arch"]] = train_family(spec)
        torch.cuda.empty_cache()
    cell = next(s for s in TRAIN_FAMILIES if s["arch"] == TRAIN_CELL_ARCH)
    out[TRAIN_CELL_ARCH]["cell"] = train_cell(
        cell, out[TRAIN_CELL_ARCH]["losses"][0])
    torch.cuda.empty_cache()
    for spec in TRAIN_FAMILIES:
        smoke = get_smoke_config(spec["arch"])
        train_path(spec["arch"], {"head_dim": 16} if smoke.hd < 16 else None)
    return out


def train_family(spec: dict) -> dict:
    """One config of :data:`TRAIN_FAMILIES` trained ``spec["steps"]`` steps
    on the card, its cut logged; counts reset just before and read just
    after: flash forward and backward :func:`train_flash_per_step` a step,
    all ``"wgmma"`` (phi-3-vision's head dim 96 too); the router
    one ``router_topk`` launch a MoE layer a step, every call
    ``"fused"``, and one ``topk_gating_bwd`` launch, no ``topk_gating``
    forward; none for a dense model.  Losses finite, and for
    :data:`TRAIN_CELL_ARCH` the mean of the last 3 below that of the first
    3.  Logs ms a step (host clock, steps 2 on), tokens/s and peak memory
    beside the card's name and power limit."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import topk_gating as tg
    from repro_torch.configs import get_config
    full = get_config(spec["arch"])
    cfg = train_family_cfg(spec)
    steps, B, S = spec["steps"], spec["batch"], spec["seq"]
    tag = f"[trainfam] {cfg.name}:"
    need = TRAIN_BYTES_PER_PARAM * full.param_count()
    if spec["layers"] is not None:
        log(f"{tag} depth cut to {cfg.n_layers} of {full.n_layers} layers: "
            f"{full.param_count() / 1e9:.3f} B parameters take "
            f"~{need / 1e9:.0f} GB to train at {TRAIN_BYTES_PER_PARAM} "
            f"bytes each, the card has 80; {cfg.param_count() / 1e9:.3f} B "
            f"kept (~{TRAIN_BYTES_PER_PARAM * cfg.param_count() / 1e9:.0f} "
            f"GB)")
    torch.cuda.synchronize()
    reset_peak()
    trainer = train_trainer(spec, steps)
    moe_layers = sum(s.moe for s in trainer.model.specs)
    captured = {}
    orig_bwd, orig_flash_bwd = tg.topk_gating_bwd, fa.flash_attention_bwd

    def capture(idx, gates, dgates, dlogits=None, **kw):
        captured.setdefault("call", ((idx.clone(), gates.clone(),
                                      dgates.clone(), None if dlogits is None
                                      else dlogits.clone()), dict(kw)))
        return orig_bwd(idx, gates, dgates, dlogits, **kw)

    def capture_flash(*args, **kw):    # the first flash backward's inputs
        if "flash" not in captured:
            captured["flash"] = ([a.detach().clone() for a in args], dict(kw))
        return orig_flash_bwd(*args, **kw)

    batches = [train_batch(cfg, spec, i) for i in range(steps)]
    torch.cuda.synchronize()
    reset_model_counts()
    tg.topk_gating_bwd = capture
    if cfg.hd == 96:
        fa.flash_attention_bwd = capture_flash
    losses, times = [], []
    try:
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            losses.append(trainer.train_one(batch, i))
            times.append(time.perf_counter() - t0)
    finally:
        tg.topk_gating_bwd = orig_bwd
        fa.flash_attention_bwd = orig_flash_bwd
    counts = model_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.mean(times[1:]))
    extras = {k: list(v.shape) for k, v in batches[0].items()
              if k not in ("tokens", "labels")}
    log(f"{tag} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters in bf16; batch {B} x "
        f"{S}{', extras ' + json.dumps(extras) if extras else ''}; "
        f"{steps} steps, losses {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"{tag} {step_s * 1e3:.2f} ms a step (host clock, steps 2 on; "
        f"first {times[0] * 1e3:.2f}), {B * S / step_s:.0f} tokens/s, peak "
        f"device memory {peak / 2**30:.2f} GiB | {SMI[0]}")
    log(f"{tag} launches {json.dumps(counts)}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses {losses} not finite")
    if cfg.name == TRAIN_CELL_ARCH and \
            not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"{tag} losses {losses} not falling")
    flash = train_flash_per_step(cfg) * steps
    variant = fa.variant(torch.bfloat16, cfg.hd)
    router = moe_layers * steps
    want = {"flash_attention": flash, "flash_attention_bwd": flash,
            "flash_by_variant": {**dict.fromkeys(fa.VARIANT_LAUNCHES, 0),
                                 variant: flash},
            "flash_bwd_by_variant": {
                **dict.fromkeys(fa.VARIANT_LAUNCHES_BWD, 0),
                fa.variant_bwd(torch.bfloat16, cfg.hd): flash},
            "router_topk": router,
            "router_calls": {"fused": router, "unfused": 0},
            "topk_gating": 0, "topk_gating_bwd": router}
    if counts != want:
        raise AssertionError(f"{tag} launches {counts}, expected {want}")
    out = {"launches": counts, "losses": losses, "step_ms": step_s * 1e3,
           "tokens_per_s": B * S / step_s, "peak": peak}
    if moe_layers:
        out["bwd_call"] = captured["call"]
    if "flash" in captured:
        out["flash_bwd_call"] = captured["flash"]
    del trainer, batches
    return out


def train_cell(spec: dict, first_loss: float) -> dict:
    """``spec``'s config through ``launch.steps.build_cell``'s train cell on
    a (data 1, model 1) NCCL mesh, world size 1: one step from the
    Trainer's first-step weights (the same draw from seed 0) and batch;
    its loss within 1e-3 relative of the Trainer's first-step loss, and
    the router's forward and backward one launch a MoE layer (the router
    kernels on the rank's local shards, ``models/moe.py::_moe_sharded``),
    flash forward and backward one a layer."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeConfig
    cfg = train_family_cfg(spec)
    B, S = spec["batch"], spec["seq"]
    tag = f"[traincell] {cfg.name}:"
    model = build_model(cfg, dtype=torch.bfloat16, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    moe_layers = sum(s.moe for s in model.specs)
    raw = _train_batch(cfg, spec, 0)
    batch = {k: torch.from_numpy(np.asarray(v)).cuda().long()
             for k, v in raw.items()}
    with nccl_world_of_one():
        mesh = make_local_mesh()
        cell = build_cell(cfg, ShapeConfig("train", S, B, "train"), mesh,
                          model=model)
        args = cell.make_args(batch)
        torch.cuda.synchronize()
        reset_model_counts()
        t0 = time.perf_counter()
        _params, _opt, loss = cell.fn(*args)
        loss = loss.detach()
        loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                     else loss)
        wall = time.perf_counter() - t0
        counts = model_counts()
        del cell, args, _params, _opt
    del model
    rel = abs(loss - first_loss) / abs(first_loss)
    log(f"{tag} mesh (data 1, model 1) over NCCL, world size 1; one step "
        f"[{B}, {S}] in {wall:.2f} s, loss {loss:.6f} against the "
        f"Trainer's first step {first_loss:.6f} (relative {rel:.3g}, tol "
        f"1e-3); launches {json.dumps(counts)}")
    if not rel <= 1e-3:
        raise AssertionError(f"{tag} loss {loss} against {first_loss}")
    if (counts["router_topk"], counts["topk_gating_bwd"],
            counts["router_calls"]["fused"]) != (moe_layers,) * 3 or \
            counts["flash_attention"] != cfg.n_layers or \
            counts["flash_attention_bwd"] != cfg.n_layers:
        raise AssertionError(f"{tag} launches {counts}; expected the router "
                             f"{moe_layers} forward and backward, flash "
                             f"{cfg.n_layers} each")
    return {"loss": loss, "launches": counts, "wall_s": wall}


@contextlib.contextmanager
def nccl_world_of_one():
    """A one-rank NCCL process group on the card (a ``FileStore`` in a
    temporary directory), destroyed on the way out."""
    import shutil
    import tempfile

    import torch.distributed as dist
    d = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(d, "store"),
                                                 1))
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)


def phase_model_timing(launches, inputs, f32_launches, f32_inputs,
                       families, encdec, giants) -> list:
    """Each model kernel's row on the inputs of its first call on the
    serving path.  The tensor-core flash row's ``launches`` count the
    serving runs at head dim 64 or 128: qwen2-moe-a2.7b, gemma3-27b,
    hymba-1.5b, whisper-medium, codeqwen1.5-7b and qwen1.5-0.5b
    (``path_launches`` each); the D = 96 row (``flash_attention_d96``)
    phi-3-vision's; both beside the SIMT kernel on the same inputs
    (``prev_*``); the two GQA rows qwen3-moe-235b-a22b's and
    qwen1.5-110b's (phase 25), and the second router row
    qwen3-moe's."""
    from repro_torch.kernels import router_topk as rt
    from repro_torch.kernels import topk_gating as tg
    rows = []
    by_path = {f"serve {ARCH}": launches["flash_attention"]}
    by_path.update({f"serve {arch}": fam["launches"]["flash_attention"]
                    for arch, fam in families.items()})
    by_path.update({f"serve {arch}": m["launches"]["flash_attention"]
                    for arch, m in encdec.items() if "flash_inputs" not in m})
    # flash attention on the first prefill's q, k, v, beside the SIMT
    # kernel, which served this path before, on the same inputs
    rows.append(_with_simt(_flash_row("flash_attention",
                                      inputs["flash_attention"], by_path),
                           inputs["flash_attention"]))
    # head dim 96, on phi-3-vision's first prefill, beside the SIMT kernel
    # that served it before
    for arch, m in encdec.items():
        if "flash_inputs" in m:
            rows.append(_with_simt(_flash_row(
                "flash_attention_d96", m["flash_inputs"],
                {f"serve {arch}": m["launches"]["flash_attention"]}),
                m["flash_inputs"]))
    # phase 25's groupings, each on its model's first prefill
    for arch, name in (("qwen3-moe-235b-a22b", "flash_attention_gqa16"),
                       ("qwen1.5-110b", "flash_attention_gqa8")):
        g = giants[arch]
        rows.append(_flash_row(name, g["flash_inputs"], {
            f"serve {arch}": g["launches"]["flash_attention"]}))
    rows.append(_router_row(rt, tg, launches, *inputs["router_topk"][0]))
    g = giants["qwen3-moe-235b-a22b"]
    rows.append(_router_row(rt, tg, {"router_topk_e128": g["launches"][
        "router_topk"]}, *g["router_inputs"][0], name="router_topk_e128"))
    # top-k gating on the f32 router's logits
    (logits, k_), _kw = f32_inputs["topk_gating"]
    T, E = logits.shape
    idx, gates = tg.topk_gating(logits, k_)
    widx, wgates = tg.topk_gating_plain(logits, k_)
    torch.cuda.synchronize()
    exact(idx.cpu().numpy(), widx.cpu().numpy())
    err = within(1e-6)(gates.cpu().numpy(), wgates.cpu().numpy())
    nbytes = T * E * 4 + T * k_ * 8
    ops = T * E * k_                      # one compare per logit per round

    def library():
        vals, ids = torch.topk(logits, k_, dim=1)
        return ids, torch.softmax(vals, dim=1)

    row = _model_row(
        "topk_gating", "src/repro/kernels/topk_gating.py:50", f32_launches,
        err, lambda: tg.topk_gating(logits, k_),
        lambda: tg.topk_gating_plain(logits, k_), library,
        ops / F32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3,
        f"T={T} E={E} k={k_}")
    # the wide path, which served this call before, on the same logits
    path = tg.path(E)
    wide = lambda: tg.topk_gating_path("wide", logits, k_)  # noqa: E731
    if not all(same_bits(a, b) for a, b in zip(wide(), (idx, gates))):
        raise AssertionError("topk_gating: the wide path's bits differ on "
                             "the f32 router's logits")
    if path != "narrow" or len(row["device_kernels"]) != 1:
        raise AssertionError(f"topk_gating: path {path}, device kernels "
                             f"{row['device_kernels']}")
    row.update(path=path, prev_path="wide", prev_ms=cuda_ms(wide, iters=20),
               prev_device_ms=device_ms(wide)[0], prev_bits_equal=True)
    log(f"[timing] topk_gating path {path}; the wide path on the same "
        f"logits {row['prev_ms']:.4f} ms (device {row['prev_device_ms']:.4f} "
        f"ms), the same bits")
    rows.append(row)
    return rows


def _with_simt(row, call) -> dict:
    """``row`` (a flash forward row) with the SIMT kernel's ``prev_*`` on
    the same inputs, checked against the plain version."""
    from repro_torch.kernels import flash_attention as fa
    (q, k, v), kw = call
    tol = 3e-2 if q.dtype == torch.bfloat16 else 2e-5
    want = fa.flash_attention_plain(q, k, v, **kw)
    simt = lambda: fa.flash_attention_variant("simt", q, k, v, **kw)  # noqa
    prev_err = within(tol)(simt().float().cpu().numpy(),
                           want.float().cpu().numpy())
    row.update(prev_variant="simt", prev_ms=cuda_ms(simt, iters=20),
               prev_device_ms=device_ms(simt)[0], prev_max_abs_err=prev_err)
    log(f"[timing] {row['name']} variant {row['variant']}; the SIMT kernel "
        f"on the same inputs {row['prev_ms']:.4f} ms (device "
        f"{row['prev_device_ms']:.4f} ms, max_abs_err {prev_err:.6g})")
    return row


def _flash_row(name, call, by_path) -> dict:
    """A flash forward row on one call's ``(q, k, v), kw`` of the serving
    path (a causal prefill): the kernel the wrapper picks against its plain
    version, bit-identical on relaunch; SDPA as the library call (GQA
    through its ``enable_gqa``); the bound
    from the visible pairs' QK^T and PV at the dtype's peak and the bytes
    of q, k, v and the output; ``launches`` summed over ``by_path``."""
    from repro_torch.kernels import flash_attention as fa
    (q, k, v), kw = call
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    got, again = fa.flash_attention(q, k, v, **kw), fa.flash_attention(
        q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: relaunch differs")
    tol = 3e-2 if q.dtype == torch.bfloat16 else 2e-5
    err = within(tol)(got.float().cpu().numpy(), want.float().cpu().numpy())
    del got, again, want
    qpos = kw.get("q_offset", 0) + torch.arange(Sq, device=q.device)
    visible = float(fa.mask(qpos, torch.arange(Sk, device=q.device),
                            kw.get("causal", True), kw.get("window"),
                            kw.get("prefix_len", 0)).sum())
    ops = 4.0 * D * visible * B * H        # QK^T and PV, 2 flops a MAC
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = H != k.shape[2]
    row = _model_row(
        name, "src/repro/kernels/flash_attention.py:101",
        {name: sum(by_path.values())}, err,
        lambda: fa.flash_attention(q, k, v, **kw),
        lambda: fa.flash_attention_plain(q, k, v, **kw),
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=gqa),
        ops / peak * 1e3,
        nbytes / HBM_BYTES_PER_S * 1e3,
        f"q {list(q.shape)} k/v {list(k.shape)} {str(q.dtype)[6:]}, "
        f"{visible:.0f} visible pairs per head")
    row.update(source="src/repro_torch/csrc/flash_attention.cu",
               variant=fa.variant(q.dtype, D), path_launches=by_path)
    return row


def _router_row(rt, tg, launches, x, w, k, name="router_topk") -> dict:
    """The fused router on a serving path's first router call (the first
    wave's prefill) and on its first 4 rows (a decode step's shape),
    beside the unfused route it replaced there (the f32 product, then the
    topk_gating kernel) and the library chain (f32 product, torch.topk,
    softmax); the row is ``name``, its launches ``launches[name]``."""
    err = check_router(f"{name} path's first call", x, w, k)

    def unfused(x=x):
        return tg.topk_gating(x.float() @ w.float(), k)

    def library(x=x):
        vals, ids = torch.topk(x.float() @ w.float(), k, dim=1)
        return ids, torch.softmax(vals, dim=1)

    def bound(T):
        d, E = w.shape
        nbytes = T * d * 2 + d * E * 2 + T * E * 4 + T * k * 8
        return 2.0 * T * d * E / BF16_OPS_PER_S * 1e3, \
            nbytes / HBM_BYTES_PER_S * 1e3

    T, (d, E) = x.shape[0], w.shape
    row = _model_row(
        name, "src/repro/kernels/topk_gating.py:50", launches,
        err, lambda: rt.router_topk(x, w, k),
        lambda: rt.router_topk_plain(x, w, k), library, *bound(T),
        f"x [{T}, {d}] w [{d}, {E}] bf16, k={k}")
    row.update(source="src/repro_torch/csrc/router_topk.cu",
               prev_route="f32 product + topk_gating",
               prev_ms=cuda_ms(unfused, iters=20),
               prev_device_ms=device_ms(unfused)[0])
    xd = x[:4]
    t_ops, t_bytes = bound(4)
    dec = {"decode_shape": f"x [4, {d}]",
           "decode_ms": cuda_ms(lambda: rt.router_topk(xd, w, k), iters=50),
           "decode_device_ms": device_ms(lambda: rt.router_topk(xd, w,
                                                                 k))[0],
           "decode_prev_ms": cuda_ms(lambda: unfused(xd), iters=50),
           "decode_prev_device_ms": device_ms(lambda: unfused(xd))[0],
           "decode_library_ms": cuda_ms(lambda: library(xd), iters=50),
           "decode_bound_ms": max(t_ops, t_bytes)}
    row.update(dec)
    log(f"[timing] {name} the unfused route on the same inputs "
        f"{row['prev_ms']:.4f} ms (device {row['prev_device_ms']:.4f} ms); "
        f"decode shape: fused {dec['decode_ms']:.4f} ms (device "
        f"{dec['decode_device_ms']:.4f} ms), unfused "
        f"{dec['decode_prev_ms']:.4f} ms (device "
        f"{dec['decode_prev_device_ms']:.4f} ms), library "
        f"{dec['decode_library_ms']:.4f} ms, bound "
        f"{dec['decode_bound_ms']:.6f} ms")
    return row


def _model_row(name, replaces, launches, err, kern, plain, library, t_ops,
               t_bytes, shape) -> dict:
    ms = cuda_ms(kern, iters=20)
    dev_ms, by_kernel = device_ms(kern)
    names = sorted(by_kernel)
    plain_ms = cuda_ms(plain, iters=5, warm=1)
    library_ms = cuda_ms(library, iters=20)
    library_dev_ms = device_ms(library)[0]
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    log(f"[timing] {name:15s} {shape:60s} kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms) | plain {plain_ms:.4f} ms | library "
        f"{library_ms:.4f} ms (device {library_dev_ms:.4f} ms) | bound "
        f"{bound_ms:.4f} ms ({bound_by}) | launches {launches[name]} | "
        f"device kernels {names}")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_device_ms": library_dev_ms, "shape": shape,
            "device_kernels": names, "checked": True}


# ---------------------------------------------------------------------------
# the two halves: the trace half here, the LM half in two child processes
# ---------------------------------------------------------------------------

#: a child's protocol lines on its standard output; every other line is its
#: log, which the parent prints behind the child's tag
READY, ROWS, PEAK = "@@ready", "@@rows ", "@@peak "
TRACE_S = "@@trace_s "
#: the timing process's peak device memory while it waits beside the LM
#: run (its ``PEAK`` is the peak after ``go``, when the LM run is over)
WAIT_PEAK = "@@wait_peak "
#: CPU threads of the LM half's torch ops (its CPU work is the smoke
#: configs'; the trace half's host work and its pool get the rest)
LM_THREADS = 2
#: the file in the parent's hand-off directory that carries the inputs of
#: the LM timing rows from the LM half's run to its timing process
HANDOFF = "lm_timing_inputs.pt"
#: the file that carries the trace kernels' main-path inputs (phase 17's)
#: from this process to the timing process
TRACE_HANDOFF = "trace_timing_inputs.pt"
#: the most device memory the LM half may hold at once, so that beside the
#: trace half's ~2 GiB the card keeps a margin
LM_PEAK_LIMIT = 70 * 2**30
#: each phase's peak device memory (bytes) before the phase reset it
PEAKS = [0]


def reset_peak() -> None:
    PEAKS.append(torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def half_peak() -> int:
    """This process's peak device memory so far, across resets."""
    return max(PEAKS + [torch.cuda.max_memory_allocated()])


def _child_setup() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(LM_THREADS)
    from repro_torch.core import plancache
    from repro_torch.kernels import build
    plancache.configure(enabled=False)
    SMI[0] = card_line()
    build.library()                 # the parent's build, loaded


def lm_half(handoff: str) -> int:
    """The LM half's run (``chip_smoke.py --lm-half DIR``, started by
    :func:`main` beside the trace half): phase 3's model kernels, serving
    (18, with its profiled prefill and decode step), the f32 router (19),
    the path (20), training (22), the families (23, each with a
    profiled decode step) and the encoder-decoder, VLM and dense models
    (24), the two configs no card holds, cut in depth, and the sharded
    cells on a (1, 1) mesh (25), and every served config trained (26);
    then the inputs of the LM timing rows saved to ``DIR`` for
    :func:`lm_timing`, and its peak memory."""
    _child_setup()
    t0 = time.perf_counter()
    phase_model_kernels()
    serve_launches, serve_inputs = phase_serve()
    f32_launches, f32_inputs = phase_f32_router()
    phase_path()
    t1 = time.perf_counter()
    train = phase_train()
    log(f"[train] phase wall {time.perf_counter() - t1:.1f} s | {SMI[0]}")
    t1 = time.perf_counter()
    families = phase_families()
    log(f"[family] phase wall {time.perf_counter() - t1:.1f} s | {SMI[0]}")
    t1 = time.perf_counter()
    encdec = phase_encdec()
    log(f"[encdec] phase wall {time.perf_counter() - t1:.1f} s | {SMI[0]}")
    t1 = time.perf_counter()
    giants = phase_giants()
    log(f"[giant] phase wall {time.perf_counter() - t1:.1f} s, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB | {SMI[0]}")
    t1 = time.perf_counter()
    trainfam = phase_train_families()
    log(f"[trainfam] phase wall {time.perf_counter() - t1:.1f} s, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB | {SMI[0]}")
    torch.save({"serve": (serve_launches, serve_inputs),
                "f32": (f32_launches, f32_inputs), "families": families,
                "encdec": encdec, "giants": giants, "train": train,
                "trainfam": trainfam},
               os.path.join(handoff, HANDOFF))
    log(f"[halves] LM half's run {time.perf_counter() - t0:.1f} s")
    print(PEAK + str(half_peak()), flush=True)
    return 0


def lm_timing(handoff: str) -> int:
    """The timing process (``chip_smoke.py --lm-timing DIR``): started
    with the run, it loads the kernels, builds the train step it will
    profile and waits; on ``go`` (the LM run and the trace half over, so
    nothing else works on the card) every timing row on the inputs the
    other processes saved: phase 17's (the trace kernels), phase 21's,
    the train step's profile and the backward kernel's row (SDPA's
    backward beside it), phase 26's profiled MoE step and the router
    backward's rows.  A process of its own that does nothing else,
    whose profiler sessions are its first: in processes that had worked
    or profiled before, sessions recorded part of the kernels or none."""
    _child_setup()
    stepper = train_stepper()      # built and run once while it waits
    print(WAIT_PEAK + str(torch.cuda.max_memory_allocated()), flush=True)
    print(READY, flush=True)
    if sys.stdin.readline().strip() != "go":
        raise RuntimeError("the LM timing process was not told to go on")
    t0 = time.perf_counter()
    trace = torch.load(os.path.join(handoff, TRACE_HANDOFF),
                       map_location="cuda", weights_only=False)
    rows = phase_timing(*trace)
    del trace
    t_trace = time.perf_counter() - t0
    log(f"[timing] phase wall {t_trace:.1f} s | {SMI[0]}")
    print(TRACE_S + repr(t_trace), flush=True)
    t1 = time.perf_counter()
    kept = torch.load(os.path.join(handoff, HANDOFF), map_location="cuda",
                      weights_only=False)
    rows += phase_model_timing(*kept["serve"], *kept["f32"],
                               kept["families"], kept["encdec"],
                               kept["giants"])
    train, trainfam = kept.pop("train"), kept.pop("trainfam")
    del kept                        # the model rows' inputs, on the card
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    rows += train_timing(train, stepper)
    del stepper
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    rows += train_family_timing(trainfam)
    log(f"[halves] LM timing {time.perf_counter() - t1:.1f} s (phase 21 "
        f"{t2 - t1:.1f} s, the train step's profile and backward row "
        f"{t3 - t2:.1f} s, phase 26's profile and router backward rows "
        f"{time.perf_counter() - t3:.1f} s)")
    print(PEAK + str(half_peak()), flush=True)
    print(ROWS + json.dumps(rows), flush=True)
    return 0


class Child:
    """``chip_smoke.py <flag> <dir>`` in a child process on the same card,
    its output read by a thread: log lines printed behind ``tag``,
    protocol lines kept.  The trace half calls :meth:`check` between its
    phases, so a child that failed fails the run there."""

    def __init__(self, flag: str, handoff: str, tag: str):
        import subprocess
        self.tag = tag
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, handoff],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1, cwd=ROOT)
        self.ready = threading.Event()
        self.rows = self.peak = self.t_ready = self.t_go = self.t_exit = None
        self.trace_s = self.wait_peak = 0
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            if line == READY:
                self.t_ready = time.perf_counter()
                self.ready.set()
            elif line.startswith(ROWS):
                self.rows = json.loads(line[len(ROWS):])
            elif line.startswith(PEAK):
                self.peak = int(line[len(PEAK):])
            elif line.startswith(TRACE_S):
                self.trace_s = float(line[len(TRACE_S):])
            elif line.startswith(WAIT_PEAK):
                self.wait_peak = int(line[len(WAIT_PEAK):])
            else:
                log(f"[{self.tag}] {line}")
        self.proc.wait()
        self.t_exit = time.perf_counter()
        self.ready.set()

    def failure(self) -> str:
        return (f"the {self.tag} process exited with "
                f"{self.proc.returncode} (its traceback is above, behind "
                f"[{self.tag}])")

    def check(self) -> None:
        """Raise if the child has exited non-zero."""
        if self.proc.poll() not in (None, 0):
            self.thread.join(timeout=10)    # its last lines printed first
            raise RuntimeError(self.failure())

    def go(self) -> None:
        """Wait until the child is ready, then tell it to go on."""
        self.ready.wait()
        if self.t_ready is None:
            self.thread.join(timeout=10)
            raise RuntimeError(self.failure())
        self.t_go = time.perf_counter()
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()

    def finish(self) -> None:
        """Wait for the child's exit; raise unless it succeeded."""
        self.thread.join()
        if self.proc.returncode != 0 or self.peak is None:
            raise RuntimeError(self.failure())

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=10)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--lm-half":
        return lm_half(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--lm-timing":
        return lm_timing(sys.argv[2])
    import shutil
    import tempfile

    from repro_torch.core import plancache
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phases 3-14 compare routes, count launches and time calls: a stored
    # result would answer them with no launch.  The cache is on only for
    # the live and served phases, which check it
    plancache.configure(enabled=False)
    if sys.argv[1:] == ["--fold"]:
        return fold_only()
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    handoff = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    lm = Child("--lm-half", handoff, "lm")
    timing = Child("--lm-timing", handoff, "lm timing")
    try:
        t_trace = time.perf_counter()
        launches, calls, routes = trace_half(
            lambda: (lm.check(), timing.check()))
        t_trace_end = time.perf_counter()
        lm.finish()
        torch.save((launches, calls, routes),
                   os.path.join(handoff, TRACE_HANDOFF))
        del calls
        trace_peak = half_peak()
        timing.go()
        timing.finish()
        rows = timing.rows
    finally:
        lm.stop()
        timing.stop()
        shutil.rmtree(handoff, ignore_errors=True)
    # the LM half's work: the run, the timing process's start (imports,
    # the card, the train step it will profile), and its timing (after
    # that process's phase 17, which is the trace half's)
    run, start = lm.t_exit - lm.t0, timing.t_ready - timing.t0
    alone = timing.t_exit - timing.t_go - timing.trace_s
    hidden = sum(max(0.0, min(b, t_trace_end) - max(a, t_trace))
                 for a, b in ((lm.t0, lm.t_exit),
                              (timing.t0, timing.t_ready)))
    work = run + start + alone
    log(f"[halves] trace half (phases 3-16) {t_trace_end - t_trace:.1f} s; "
        f"LM half {work:.1f} s of work: its run {run:.1f} s and its timing "
        f"process's start {start:.1f} s beside the trace half, its timing "
        f"{alone:.1f} s alone after phase 17 ({timing.trace_s:.1f} s); "
        f"{hidden:.1f} s of it hidden "
        f"by the trace half = {hidden / work:.1%}")
    total = torch.cuda.get_device_properties(0).total_memory
    # the timing process waits beside the LM run, and times after it
    lm_peak = max(lm.peak + timing.wait_peak, timing.peak)
    log(f"[halves] peak device memory: trace half {trace_peak / 2**30:.2f} "
        f"GiB, LM half {lm_peak / 2**30:.2f} GiB (run "
        f"{lm.peak / 2**30:.2f} beside the timing process's wait "
        f"{timing.wait_peak / 2**30:.2f}; its timing after the run "
        f"{timing.peak / 2**30:.2f}), sum "
        f"{(trace_peak + lm_peak) / 2**30:.2f} of {total / 2**30:.2f} GiB")
    if trace_peak + lm_peak >= total:
        raise AssertionError("the halves' peaks exceed the card's memory")
    if lm_peak >= LM_PEAK_LIMIT:
        raise AssertionError(f"the LM half's peak {lm_peak / 2**30:.2f} GiB "
                             f"is above {LM_PEAK_LIMIT / 2**30:.0f} GiB")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(device["smi"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


def fold_only() -> int:
    """``python3 chip_smoke.py --fold``: phases 1-2, main-10M (phase 5),
    pack-10M (phase 8) and the fold phases over its shards (8b, 14b; their
    eager results computed here), each phase's wall logged; it prints no
    contract line."""
    import tempfile
    t_start = time.perf_counter()
    phase_device()
    phase_build()

    def timed(label, run):
        t0 = time.perf_counter()
        out = run()
        log(f"[{label}] phase wall {time.perf_counter() - t0:.1f} s | "
            f"{SMI[0]}")
        return out

    trace, launches, _calls, main_digests = timed("main", phase_main)
    with tempfile.TemporaryDirectory() as d:
        pool, workers, _start_s = start_pool()
        try:
            kept = {}
            timed("pack", lambda: phase_pack(main_digests, launches, pool,
                                             workers, d, kept))
            timed("fold", lambda: phase_fold(kept["shards"], kept["eager"],
                                             pool, workers))
            timed("fold hosts", lambda: phase_fold_hosts(
                trace, kept["shards"], pool, workers))
        finally:
            pool.close()
    log(f"[done] --fold {time.perf_counter() - t_start:.1f} s")
    return 0


def trace_half(check):
    """Phases 3-16 on the trace path, ``check()`` between them, each
    phase's wall logged; returns the main path's launches and kernel calls
    and every route's launches, for phase 17."""
    import tempfile

    def timed(label, run):
        t0 = time.perf_counter()
        out = run()
        log(f"[{label}] phase wall {time.perf_counter() - t0:.1f} s | "
            f"{SMI[0]}")
        check()
        return out

    timed("kernels", phase_kernels)
    timed("reader", phase_reader)
    trace, launches, calls, main_digests = timed("main", phase_main)
    stream_launches, stream_wants, stream_trace = timed("stream",
                                                        phase_stream)
    routes = {"query": timed("query", lambda: phase_query(trace)),
              "stream": stream_launches}
    with tempfile.TemporaryDirectory() as d:
        pool, workers, _start_s = start_pool()
        try:
            kept = {}
            routes.update(timed("pack", lambda: phase_pack(
                main_digests, launches, pool, workers, d, kept)))
            shards = kept.pop("shards")
            routes.update(timed("fold", lambda: phase_fold(
                shards, kept.pop("eager"), pool, workers)))
            from repro_torch.tracegen import big_trace
            stream_paths = big_trace(os.path.join(d, "stream"), **STREAM)
            routes.update(timed("parallel", lambda: phase_parallel(
                stream_wants, pool, workers, stream_paths, d)))
            routes.update(timed("formats", lambda: phase_formats(
                stream_trace, stream_wants, pool, d)))
            del stream_trace
            analysis = {}

            def analysis_phase():
                out, analysis["digests"] = phase_analysis(
                    trace, kept.pop("members"), stream_paths, pool,
                    workers, d)
                return out

            for label, phase in (
                    ("set", lambda: phase_set(trace, kept)),
                    ("set-stream", lambda: phase_set_stream(
                        stream_paths, pool, workers)),
                    ("diagnose", lambda: phase_diagnose(
                        trace, stream_paths, pool, workers, d)),
                    ("analysis", analysis_phase),
                    ("fold hosts", lambda: phase_fold_hosts(
                        trace, shards, pool, workers)),
                    ("extensions", lambda: phase_extensions(
                        trace, stream_paths, d))):
                routes.update(timed(label, phase))
        finally:
            pool.close()
        del trace
        routes.update(timed("live and served", lambda: phase_live_and_served(
            main_digests, os.path.join(d, "pack"), analysis["digests"])))
    return launches, calls, routes


if __name__ == "__main__":
    sys.exit(main())
