#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``finchat_tpu_torch``), one H100.

    python3 chip_smoke.py            # every phase, as the acceptance run does

Phases, in order; any failure exits non-zero and prints no result line:

1. Device and build: the card's name and power limit (``nvidia-smi``), then
   the CUDA kernels built from ``finchat_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (build seconds printed), and the registers, stack and spills
   of the Hopper kernels (``cuobjdump -res-usage``), the bf16 prefill body
   (``attention_bf16_sm90.cu``: its paged, ragged and contiguous entries),
   K7's Hopper backward (``flash_attention_bwd_sm90.cu``), the fused
   dequant matmul's decode body (``quant_matmul_decode_sm90.cu``) and the
   KV-row writer (``kv_write_sm90.cu``) among them; a Hopper attention
   kernel or a writer kernel that spills (stack or local memory) fails the
   run.
2. Kernels against their plain PyTorch versions on the card, at the serving
   shapes of Llama-3-8B (32 query heads, 8 KV heads, head_dim 128,
   page_size 128, 64 pages per sequence), over a bf16 cache and over an
   int8 cache with its scale planes: paged attention (decode B=64 C=1 over
   1-4k-token contexts and B=8 at the serve's 5,236 tokens; prefill B=4
   C=512 at q_offset 0 and 1024, and over the bf16 cache at the serve's
   q_offset 2048 and a lone 512-token chunk, B=1, at q_offset 0 and
   2048), the
   decode KV append (B=64 with invalid lanes; the int8 one quantizes) by
   name, beside it the KV-row writer that the engine writes every cache
   row through (``kv_write_sm90.cu``: ``kv_append_sm90``, and
   ``kv_append_q8_sm90`` quantizing; the decode step's 64 lanes, the 4 x 512
   chunk at q_offset 2048 and the serve-shaped round padded to its 2,048
   bucket, against the chunk scatter, every page bit-exact but the trash
   page where padding lanes share its rows, two launches identical), and
   ragged attention (two 512-token prefill rows, 60 decode rows, padding to
   a 2048 bucket; over the bf16 cache also a round shaped like the serve's,
   three 512-token rows at q_offset 1024, 2048 and 4096 beside 4 decode rows
   at 5,236 tokens). Decode goes to the Hopper decode body
   (``attention_decode_sm90.cu``) over both caches; the prefill chunks go to
   the Hopper prefill body of their cache (``attention_bf16_sm90.cu``,
   ``attention_q8_sm90.cu``); over the int8 cache the ragged round to the
   Hopper int8 body, over the bf16 cache to a pair of launches — the
   prefill tiles through the bf16 prefill body's ragged entry, the one-token
   rows through the decode body's — each entry held on its own rows and its
   launch timed alone against its own bound, plain version and SDPA calls,
   and the pair timed together; wherever the routing picks a Hopper body, the
   older body is held and timed beside it on the same inputs; every
   attention launch runs twice and must give identical outputs. Then the fused
   dequant matmul: the decode body (``quant_matmul_decode_sm90.cu``) at the
   decode step's M=64 on every llama3-8b layer weight shape — [4096, 4096]
   (q, o), [4096, 1024] (k, v), [4096, 14336] (gate, up), [14336, 4096]
   (down) — and on the [4096, 128256] head with fp32 output, and at the
   prefill chunk's M=4 head call; int4 at M=64 on [4096, 14336], per
   column and per group of 128; the Hopper kernel at prefill (M=2048 and
   the ragged round's M=1084, int8 on every weight shape and int4 per group
   of 128 on [4096, 14336]); v2 held and timed beside each on the same
   inputs, launched by its own name. The wrapper must launch the kernel its
   routing rule names, each kernel launches twice with identical outputs,
   and its time is that of one launch of 20 captured in a CUDA graph (the
   library call's likewise; no host work between launches, which would
   pace the small shapes), the routed wrapper's time beside it. Each case
   prints its max abs error; attention is held per
   output row (one token of one head) to min(2e-2, 2^-6 of the row's
   largest reference value), two bf16 ulps; a bf16 matmul output row to
   2^-7 of its largest value (one ulp: both sides round an fp32 sum of the
   same exact products); the fp32 head per element to K * 2^-22 * (|x| @
   |w|), a bound on two fp32 summations of K = 4096 products in any order;
   the appends bit-exact. Then it prints the kernel's and the plain
   version's median time per call over 20 CUDA-event-timed runs (each of
   back-to-back calls filling ~1 ms, at most 20; an attention kernel's
   launch is timed alone, its call's checks and tile descriptors built
   once, and the routed wrapper's time, host work included, beside it; the
   appends' launch and K7's backwards as one launch of 20 in a CUDA graph,
   their yardsticks likewise, the wrapper's time beside it; the writer, its
   plain version and its yardstick likewise),
   the bound (the
   larger of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s, counted from this
   run's inputs) and a library yardstick the port never calls:
   ``scaled_dot_product_attention`` over the pre-gathered (dequantized) KV
   on the same work, ``index_put_`` of the same rows for the bf16 append
   and the bf16 writer,
   ``torch.matmul`` with the already dequantized bf16 weight for the
   matmul (none for the quantizing append and writer: no one call quantizes
   and scatters). Last, contiguous flash attention (K7, the training path):
   the forward causal at B=1 S=2048 and with ``q_offset`` 1024 / ``kv_len``
   1536 at B=4 Sq=512, through the bf16 prefill body's contiguous entry
   (``flash_attention_sm90``, the kernel ``flash_kernel_for`` names) with the
   older forward (``flash_attention.cu``) by name beside it, each launched
   twice over an output and log-sum-exp filled with NaN (identical results),
   held per row as above plus the log-sum-exp (1e-3); and the backward at
   both cases, fed by the Hopper forward's out and log-sum-exp: the Hopper
   backward (``flash_attention_bwd_sm90``, the kernel
   ``flash_bwd_kernel_for`` names) with the older backward
   (``flash_attention.cu``) by name beside it, each launched twice over dq,
   dk and dv filled with NaN (identical results), each against the plain
   backward on the same inputs (per tensor ``||err|| / ||want|| <= 1e-2``,
   per row ``max|err| <= 2^-5 * max(row max, 2^-10 * tensor max)``: the
   kernels round dS to bf16 before their products) and against autograd of
   the plain ``mha_reference`` in fp32 on the same bf16 inputs (per tensor
   1e-2). Yardstick: ``scaled_dot_product_attention`` forward, and its
   backward through autograd, on the same work. Then K8 at the int8
   encoder's shapes (``bge-base-en``: [768, 2304] qkv, [768, 768] attn_out,
   [768, 3072] mlp_in, [3072, 768] mlp_out) at M=2048 (an ingest dispatch:
   the Hopper kernel) and M=32 (a lone query: the decode body), under the
   same rules; their launches are the retrieval phase's: the int8
   ingest's window for M=2048, the int8 queries' window for M=32.
3. Retrieval (``retrieval_phase``): ``bge-base-en`` with random weights
   from a seeded generator, bf16 and int8 (K8), texts framed by the 8B's
   ``ByteTokenizer``. 4,096 transactions of 64 users (seeded: kind x
   merchant x amount x date, three double charges a user) ingested by each
   encoder through ``TransactionRetriever.upsert_transactions`` from worker
   threads, 8 texts a call, the microbatcher bound to the loop (the
   threadsafe path coalesces them); then 258,048 seeded random unit vectors
   of 1,024 other users, dated over 730 days, into the bf16 index: 262,144
   rows on the card. 64 retrievals at once through ``structured``, one a
   corpus user, half over the last 30 days, half of 10 rows: every hit
   list, and ``query_points`` run serially on the same query vectors, must
   hold only the user's rows and equal a float64 numpy search of the host
   copy (ties to the lower row; the same row wherever a score is more than
   1e-5 from its neighbours, overlap >= 0.99). The same 64 retrievals then
   go one at a time through the int8 retriever's ``structured`` (the
   batcher; lone queries) and are held to the plain search over the int8
   index. The int8 encoder's top-10 over the corpus, on those query
   vectors, must overlap the bf16 one's >= 0.99 (near ties within 2e-3
   count). K8's launches are read in two windows, each reset just before:
   the int8 ingest must launch only the Hopper kernel, 48 a dispatch; the
   int8 queries only the decode body, 48 a query; neither v2.
   Printed: ingest texts/s of both, embed dispatches a request, the
   retrieval embed and search seconds, one scoring call at B=32 over the
   collection on the card against its bound, peak memory. The bf16
   retriever stays for the agent's stub turns.
   Serve: ``llama3-8b`` with random bf16 weights from a seeded generator,
   ``EngineConfig``'s defaults with only ``kv_quant`` and the session disk
   tier's directory (a temporary one) set — the prefix and session KV
   caches, recompute preemption and the circuit breaker on — behind the
   scheduler, ``EngineGenerator`` and ``LLMService``. The engine's
   ``warmup()`` runs first, as the app runs it at start: its seconds, step
   variants, launches by kernel and peak memory are printed, and every page
   but the trash page must still be all zero after it (one device
   reduction). The rendered system head is registered first, as the
   app registers it (BOS added, the last token dropped: 30 whole pages);
   then four greedy requests at once, four more once the first tokens
   stream (so prefill coexists with decode and the packed ragged rounds
   run), 64 new tokens each, each its own conversation. Every request must
   complete; every kernel of the plane must be launched in this window
   (counts set to 0 just before the registration), the older paged body
   may not be launched at all (nor K3 on the bf16 plane, nor, on the
   quantized planes, K8's v2: every matmul of at most 64 rows, decode
   steps and heads, goes to the decode body), and the Hopper prefill body
   of the plane's cache must take every prefill chunk, one launch a layer;
   the KV-row writer of the plane's cache must take every cache write, one
   launch a layer of every decode step, prefill chunk and ragged round, and
   the older appends none. The prefix cache must hit 8/8, saving 8 x 3,840
   tokens, and the prefill rows and tokens the steps carried must equal
   what the prompts need past the head. Every served stream is then checked
   teacher-forced against the plain dense forward (same weights, plain
   attention). Turn 2: four of the conversations send their history plus a
   new message (16 new tokens), on the same scheduler: 4/4 must resume from
   their cached pages (RAM or disk) and prefill only the rest; then the
   head's pages must be bit-identical to their state just after the
   registration. Turn 3: after ``spill_sessions()`` and
   ``retire_prefixes()`` (no page may stay allocated), a fresh scheduler on
   the same engine and directory registers the head again and two
   conversations resume from disk (2/2). Each later turn is a window of its
   own for the launch rules and the teacher-forced checks, and prints its
   TTFT and its restore and offload seconds. Then one decode step, one
   prefill chunk and one serve-shaped ragged round at the served context
   length are timed and profiled (device time by kernel class, and the
   device's idle share of the profiled window). Then the resilience drills
   on the same weights. The breaker drill: on the serve's engine, four
   requests stream over the registered head; once each has 2 tokens,
   ``scheduler.decode`` fails ``breaker_threshold`` times (a fault armed
   only inside the drill); the trip rebuilds the pool on the card, an
   ``on_rebuild`` callback re-registers the head, and the streams replay
   cold. Every stream must complete teacher-forced, the rebuild counter rise
   by one and the breaker close; every kernel of the plane must launch
   after the trip (counts set to 0 in the callback) with the serve's launch
   rules, and no older body; peak memory across the rebuild must stay below
   the memory held before the drill plus one pool; a request after the drill
   must hit the re-registered head. The rebuild and recovery seconds and the
   replays' first token after the trip are printed. The preemption drill: a
   second engine over the same weights whose pool holds the head's pages
   and two requests' own pages but not three; two requests without a
   deadline, then one with a deadline 60 s out, which must preempt (at
   least one preemption; all three teacher-forced, each ending at its
   budget or EOS); then two more requests and ``shutdown_drain()`` once each
   has a token: each must end with the ``shutting_down`` error, its history
   on the session tier's disk, and no page left but the head's.
   Tracing: turn 1 runs traced (every request with a ``trace_id``; tracing
   is on by default): each request's timeline must hold its lifecycle
   marks, and the dispatch events must name it in their rows exactly as
   often as the engine's steps carried its slot (counted at the engine);
   the window is written as a Chrome trace, and tracing's host µs a decode
   dispatch is measured at 8 and 64 rows. The breaker drill writes the
   flight recorder to a temporary directory: the trip's dump must load with
   its checksum (``load_flight_dump``) and hold the trip and dispatches.
   ``device_trace`` over two decode steps must write a profiler trace with
   the engine's ``kv_append`` and ``paged_attention`` ranges, one a layer.
   The agent's planes, after the later turns on the serve's engine with the
   head registered on a scheduler of their own: grammar-constrained decode
   with the tool grammar bound to the model's 128,256-wide vocab (its
   ``GrammarVocab`` constructor over ``ByteTokenizer``'s texts, empty texts
   past them), four constrained and four plain requests, greedy, 64 new
   tokens at most, in waves that send a constrained row down every path
   (the prefill round's pick, the ragged round's completions and decode
   rows, a depth-2 step a pending slot sits out, the depth-1 step when
   every decoding slot waits on a pick). Every constrained output must
   leave the DFA live or accepting and parse; every plain stream passes the
   teacher-forced check, every constrained one the same check under the
   grammar mask each token was picked under; a slot that sat out a step
   must keep its context length and last token, and for the first four
   such steps every page of its context bit-identical; the serve's launch
   rules hold. Then a decode step's time with one constrained row against
   none, the fetch of one logits row and the host pick. On bf16, partial
   holds: ``submit_partial`` of the rendered head plus context, parked,
   grafted by ``extend_prompt`` after 0.2 s (the retrieval), teacher-forced,
   ``finchat_partial_grafts_total`` up by one, TTFT from the graft printed
   beside a plain submit's of the same prompt; a divergent graft must be
   refused and its cancel leave no own page and the head's refcount as it
   was. Then the agent (``agent_turns``): Penny turns through
   ``LLMAgent.stream_with_status`` on a scheduler of its own at
   ``EngineConfig()`` with both of the agent's prompt heads registered, the
   prompts of ``prompts/``, a fake retriever (0.2 s, fixed rows), greedy,
   96 decision and 64 response tokens at most. Four engine-decided turns,
   two at a time, both roles on the model (the decision's tool grammar
   bound through the generator's own ``GrammarVocab.for_tokenizer`` over a
   ``ByteTokenizer`` as wide as the logits rows): the reference's event
   protocol, the decision accepting and the streamed parser agreeing with
   ``parse_tool_decision``, both streams teacher-forced (the decision under
   its grammar mask), one graft a retrieving turn with the hold taken at
   name-commit, the pages after the turns those before. Then two turns
   decided by a paced ``StubGenerator`` with the overlap and tool streaming
   on, then off, over the retrieval phase's real retriever (two corpus
   users; each count the plain search's): byte-identical responses; on, one launch a turn adopted,
   the hold at name-commit (trace marks) and grafted, the response TTFT
   from the turn's start and ``finchat_tool_overlap_saved_seconds``
   printed on and off. Every kernel of the plane must launch in these
   turns, under the serve's launch rules. Last, a turn abandoned once its
   response has a token: no hold, slot or own page left, the heads'
   refcounts unchanged.
   Then ``app_turns``, once the serve's engine and weights are released: the
   serving app at full width, bf16 — ``build_app`` builds the 8B itself
   (random weights from ``model.seed``, a ``ByteTokenizer`` as wide as the
   logits rows, ``EngineConfig()``'s defaults, warmup, both prompt heads
   registered) and, with no ``retriever=``, its own retriever (``bge-base-en``,
   the on-device index snapshotting to a temporary directory), over an
   ``InMemoryBroker`` and an ``InMemoryStore`` of four conversations,
   greedy, 64 new tokens. Driven through the consume loop: 12 transactions
   of each conversation's user first (three users over ``POST
   /transactions``, one batch on the ``transaction_upsert`` topic), then
   four messages at once, a second turn of
   two conversations (resumed through the session cache), a redelivered
   answered message (deduped, nothing produced); over HTTP ``/health``,
   a ``/chat/stream`` turn, ``/metrics`` and ``/debug/trace/<message_id>``;
   then ``drain_and_stop()`` (no slot or page left beyond the heads, the
   session entries on disk, the journal holding exactly the answered ids,
   the index's snapshot loading back with the live index's hits). A turn
   whose decision retrieved must report the plain search's count for its
   arguments. Every outbound record follows the chunk protocol, each stored answer is
   its turn's chunks, every stream is teacher-forced, and every bf16
   serving kernel launched under the serve's launch rules. It prints the
   build's seconds and peak memory, TTFT from Kafka ingress (the trace's
   ingress event to the response's first token) and the app's share of it,
   the same for the HTTP turn, and the phase's seconds.
   Then the CLI: ``python -m finchat_tpu_torch --preset llama3-8b --config
   <json>`` in a subprocess (its in-memory store seeded with one
   conversation first; the config names ``bge-base-en`` and a snapshot
   directory): ``GET /health``, ``POST /transactions`` of 8 rows, one
   ``/chat/stream`` turn in the reference's event order, then SIGTERM: exit
   0 within the shutdown deadline, the graceful drain in its log, the
   snapshot holding the rows.
   Then ``checkpoint_phase``: ``llama3-8b``'s seeded bf16 tree and
   ``bge-base-en``'s written as HF safetensors checkpoints by the port's own
   writer (four shards and a ``config.json``; q/k/v un-fused and a zero
   token-type table for bge) into a temporary directory (the phase fails
   first when its filesystem has under 20 GB free), loaded back by
   ``checkpoints/hf_loader.py`` in bf16 (every leaf bit-equal to the
   source's) and with ``quant="int8"`` at load (every leaf bit-equal to
   ``quantize_stacked`` of the source's), the RSS growth of the write and
   of each load held under 4 GB; then ``build_app`` over both checkpoints on
   the int8+kv8 plane (``EngineConfig()`` otherwise, warmed up): the app's
   encoder embeds a query bit-equal to one over the source bge tree, and
   two Kafka turns run through the consume loop, every stream
   teacher-forced on the loaded tree, every int8 serving kernel launched
   under the serve's launch rules. It prints the write and load seconds,
   the peak device memory above the source tree (bf16) and of the int8
   load against the int8 tree plus its largest bf16 leaf, the peak RSS,
   and each turn's TTFT from ingress and decode rate.
4. Serve the quantized plane the same way: int8 weights made by
   ``init_quantized_params`` (the bf16 tree never exists) and an int8 KV
   pool, warmed up, the same head, 8 requests in two waves and later turns.
   The teacher-forced check runs the plain forward on the dequantized
   weights with every K/V row quantized and dequantized as the cache stores
   it; the traced window, the constrained decode (its head through K8's
   decode body), one pair of the agent's engine-decided turns, then the
   step profile and the breaker drill (the pool rebuilt with its scale
   planes) with its flight dump.
5. Serve int4 weights (per group of 128) over the int8 KV pool, warmed
   up: the head registered, two requests, one after the other's first token, 16 new
   tokens each, with the same prefix-cache and teacher-forced checks — the
   path of the int4 matmul kernel.
5b. The decode planes (``decode_planes``): ``llama3-8b`` at full width
   over ``PLANE_DEPTH`` (8) of its 32 layers, with random weights from a
   seeded generator, bf16 then int8 weights over the int8 KV pool. Each run is an engine at ``EngineConfig(kv_quant=..., **run)``:
   bf16 at depth 1, ``decode_loop_depth=4``, ``spec_tokens=3`` and
   ``freerun_rounds=4`` with ``decode_loop_depth=2``; int8+kv8 at depth 1
   and ``decode_loop_depth=4``. Each is warmed up (the pages past the trash
   page still zero; at depth > 1 ``decode_loop_step`` is captured there as
   a CUDA graph), the system head registered, then 8 greedy requests of 64
   new tokens in two waves through ``LLMService``. Every stream must pass
   the teacher-forced check and equal the depth-1 run's stream of the same
   prompt token for token, except that the two may part at a token whose
   plain-forward margin (the prefixes equal) is at most 0.25. A replayed
   block must equal the eager ``decode_loop_step`` on a copy of the same
   state (tokens, context lengths, last tokens, every page), at warmup and
   again after ``rebuild_device_state`` (the graph dropped and captured
   anew), each replay adding the launches its capture
   recorded. Each run's launches are a window of their own (counts set to
   0 just before the head's registration): the KV-row writer takes one
   launch a layer of every forward iteration the engine's calls ran (a
   block's K, a round's fused tails, a capture's rounds), the older paged
   body exactly the verify steps' attention, no older append, and every
   kernel of the plane launches. The spec run must accept a draft (its
   acceptance rate printed), the free-run run capture at least once with
   fewer dispatches than rounds in the coexist window and no divergence.
   Printed: decode tokens/s aggregate and per stream beside the earlier
   ``EngineConfig()`` serves' (PERF.md §5), TTFT,
   peak memory with the graph, and on the loop-4 runs a block's time a
   token, device busy and idle share (``torch.profiler``) against a single
   decode step's at the served context. Phase 2's ``paged_verify_c4``
   cases (the verify step's C = 4 query tokens a slot: B=64 over 1-4k
   tokens, B=8 at 5,236) take their launches from the spec run's window.
5c. Bounded KV (``bounded_kv``): the same model at ``PLANE_DEPTH`` layers
   under a sink of 1 page and a window of 16: every row evicts through the
   Hopper bodies.
5d. The engine fleet (``fleet_phase``): ``build_app`` with three
   ``llama3-8b`` bf16 replicas, ``fleet.roles`` "prefill,decode,decode",
   over one weight tree (every engine's parameter tensors the same,
   ``data_ptr``; each replica grows device memory by its KV pool only).
   Four cold Kafka turns land on the decode replica the router computed in
   this script picks, each decision and response prefilled on replica 0
   and handed over (the handoff's seconds); a cold turn with replica 0 out
   of the pool prefills locally (its TTFT beside the handed-off ones). A
   turn whose response streams on replica 1 gets replica 1's decode and
   rebuild wedged: the breaker drains it to replica 2 (its chunks decode
   to its served tokens), probes trip replica 1 to its give-up (OUT), and
   healed it respawns (its pool rebuilt on a worker thread while replica 2
   serves a turn) and the drained conversation's next turn routes back,
   migrating its session bytes. Every stream is teacher-forced; every bf16
   serving kernel launches in the phase's window under the serve's launch
   rules summed over the replicas (the ``fleet_launches`` of the kernels
   line), and the drain leaves no slot or page beyond the heads.
5e. The warm-state fabric (``fabric_phase``): ``build_app`` with two
   ``llama3-8b`` bf16 replicas and ``fabric.enabled`` at a temporary path.
   Replica 0 prefills the two prompt heads and publishes them; replica 1's
   registrations are fabric hits with no prefill chunk (each head's
   seconds on both). Two Kafka turns on replica 0 at once; a follow-up of
   one submitted to replica 1, which never saw it, resumes warm from the
   shared tier (fabric hits, ``finchat_fabric_restore_seconds``) and equals
   the same submission on replica 0. A turn on replica 1, then replica 1
   out of the pool: the next turn routes to replica 0 by the holder index,
   the source keeps no RAM copy and the shared records stay. A wedged
   replica 1 gives up and respawns with both heads from the fabric (no
   prefill chunk; its seconds beside PR 23's), and a turn on it rides them.
5f. The pod (``pod_phase``): two hosts in one process, each a ``build_app``
   with its own ``llama3-8b`` bf16 tree (host A two replicas, since a
   one-engine app serves no pull; host B one), one consumer group, one
   store, one journal directory, liaisons over loopback TCP, the fabric
   off. A serves turn 1 of three conversations; B joins and two of them
   move to it; their turn 2 on B pulls the session records from A (each
   record's bytes, ``finchat_pod_transfer_seconds``, the event loop's
   longest stall in a pull), and the short one resumes warm with the
   stream of the same submission on A. A is killed: B declares it dead,
   evicts its member, adopts its partitions and replays A's journal, so A's
   answered message delivered again is skipped; the third conversation's
   next turn, with no live peer, starts cold and answers. Both phases:
   every stream teacher-forced, every bf16 serving kernel launched in the
   window (``fabric_launches``, ``pod_launches``), no older body. The
   fleet, fabric and pod phases' decisions stop at ``PLANE_DECISION_NEW``
   (32) tokens, the agent phases' at ``DECISION_NEW`` (96).
5g. MoE (``moe_phase``): ``mixtral-8x7b`` at full width and depth (32
   layers, 8 experts a layer, top 2, vocab 32,000), int8 weights made by
   ``init_quantized_params`` (each expert leaf one layer's ``[E, D, F]``
   slice at a time; its bf16 tree, 93 GB, does not fit the card) over an
   int8 KV pool sized to the memory left but ``MOE_HEADROOM_GB``, 8 slots
   (``MOE_SLOTS``), ``EngineConfig``'s defaults otherwise, warmed up, the
   system head registered, then ``MOE_REQUESTS`` (4) greedy requests of
   ``MOE_NEW`` (32) new tokens through ``LLMService`` in two waves. The expert einsums run
   on inline-dequantized weights (``models/llama.moe_mlp``, as the JAX
   package computes them): every other matmul and all attention through
   the int8+kv8 plane's kernels under its launch rules (K4's Hopper
   prefill body every chunk, its decode body, the writer every cache
   write, K6's Hopper body, both K8 bodies; K8's v2 and the older int8
   append never), ``finchat_quantmatmul_fallbacks_total`` up (0 in phase
   4's dense serve), every dispatch on
   ``finchat_quantmatmul_fused_dispatches_total``, every stream
   teacher-forced against the plain forward on the same quantized tree
   (each layer's experts dequantized in turn). Phase 2's K8 cases
   ``int8_m{64,4}_head32000_fp32`` (the Mixtral head) take their launches
   from this window. Prints the init seconds and peak against the int8
   tree, the pool, TTFT, the decode rate and a decode step's profile
   (device time by class, PyTorch's elementwise kernels a class of their
   own).
5h. Tensor parallelism (``tp_phase``): ``llama3-8b`` at ``PLANE_DEPTH``
   layers, full width, seed 0, greedy, ``TP_NEW`` (32) new tokens over the
   registered head. (a) A one-rank NCCL mesh against no mesh, 8 requests
   at depth 1 and at loop 4 (the loop's CUDA graph captures the NCCL
   all-reduces): the streams bit-equal and every kernel's launches equal.
   (b) Two gloo ranks on the one card (rank 1 a spawned process following
   rank 0's engine calls), bf16 then int8+kv8, ``TP_REQUESTS`` (4)
   requests at depth 1 (gloo is not captured): every stream teacher-forced,
   the plane's kernels launched and the two ranks' launches equal; a
   conversation's KV offloaded at TP=2 into one record, restored into a
   one-device engine whose next turn is teacher-forced. (c) The route of
   every rank shape and the weight bytes a rank against one device. (d) K8
   at a rank's shapes (M=64 and 2,048, the head at M=64) and the decode
   body at 4 KV heads against their plain versions, timed (rows ``tp_*``,
   their launches rank 0's in (b)). No number of the phase is a TP speed.
6. Train: first ``llama3-8b`` widths at 2 layers, B=1, S=2048 — the loss,
   every leaf's gradient and the one-shot forward's logits through K7
   against the same step with the plain attention (relative per leaf and on
   the logits <= 5e-2, loss within 1e-2: both paths round every activation
   to bf16, and a one-ulp difference in an attention output spreads through
   the bf16 layers after it). Then the full model, 32 layers, random bf16
   weights: five AdamW steps (``train/train_step.py``, remat on) on one
   fixed batch of 2048 tokens. Every loss must be finite and the fifth
   below the first; in each step the Hopper forward must launch 64 times
   (each layer's forward, again in the backward under remat), the older
   forward never, the Hopper backward 32 times and the older backward
   never (counts set to 0 just before).
   Prints the step time, tokens/s, the
   model-FLOP share of the bf16 peak, the peak memory, and a sixth step's
   device time by class (profiler).

The line before the last is the ``kernels`` JSON (each row's
``launches`` from its plane's serve or run, ``checkpoint_launches`` from
the checkpoint phase's serve, ``fleet_launches``, ``fabric_launches`` and
``pod_launches`` from the fleet, fabric and pod phases, ``moe_launches``
from the Mixtral serve, ``tp_one_rank_launches``, ``tp_rank0_launches``
and ``tp_rank1_launches`` from the tp phase's ranks); the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is visible or when the port package is not beside this file.
"""

from __future__ import annotations

import ast
import asyncio
import gc
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
# attention is held per output row (one token of one head, head_dim values):
# max|got - want| <= min(ATOL, REL_TOL * max|want|). Both sides round their
# output to bf16, one ulp apart at worst (2^-7 of the row's top binade), and
# round P to bf16 at different points of the fp32 softmax; REL_TOL is two
# ulps at the row's own scale, so a dropped key tile or a mis-weighted split
# shows at any context length, and ATOL caps rows of large values (a query
# with a handful of keys) at the former flat limit.
REL_TOL = 2.0 ** -6
ATOL = 2e-2
# fused dequant matmul: a bf16 output row within one ulp of its top binade;
# an fp32 output element within K * 2^-22 of the sum of |x| |w| products
QMM_ROW_TOL = 2.0 ** -7
QMM_F32_TOL = 2.0 ** -22
# the prefill cases of the fused dequant matmul: a 4 x 512 chunk and the
# ragged round of two 512-token rows and 60 decode rows, on every llama3-8b
# weight shape — q and o, k and v, gate and up, down ([K, N])
QMM_PREFILL_ROWS = (2048, 1084)
QMM_PREFILL_WEIGHTS = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# the decode step's seven matmuls a layer at M=64, by their four shapes
QMM_DECODE_WEIGHTS = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
                      "down": (14336, 4096)}
# K7's backward against its plain version on the same inputs: the kernel
# rounds dS to bf16 (2^-9 relative) before its products, the plain version
# keeps it in fp32, and both round each gradient to bf16 (an emulation of
# those rounding points on the CPU, tests/test_torch_k7_rounding.py: 2.6e-3
# per tensor, a quarter of the row limit).
# The row floor is for rows whose gradient vanishes: the first query of a
# causal sequence sees one key, so its dS is zero up to fp32 cancellation.
GRAD_REL_TOL = 1e-2
GRAD_ROW_TOL = 2.0 ** -5
GRAD_ROW_FLOOR = 2.0 ** -10
# the training check, K7 against the plain attention through 2 full-width
# layers: every activation is bf16 on both paths, so a one-ulp difference in
# an attention output spreads through the layers after it (the emulation at
# dim 1024: 0.9-1.4e-2 per leaf, 1.0e-2 on the logits, 5e-5 on the loss)
TRAIN_REL_TOL = 5e-2
TRAIN_LOSS_TOL = 1e-2
REPO = Path(__file__).resolve().parent
# the serving planes: the kernels each must launch, and its quant modes
# decode (C = 1 at page 128) goes to the Hopper decode body on every plane;
# prefill chunks (64-row blocks, page 128) to the Hopper prefill body of the
# cache — bf16 (attention_bf16_sm90.cu) or int8 — and the older paged body
# nothing; bf16 ragged rounds to the pair of Hopper ragged entries (the
# prefill tiles through the bf16 prefill body's, the one-token rows through
# the decode body's) and K3 nothing; K8: the Hopper kernel serves prefill
# (more than 64 rows), the decode body every call of at most 64 rows (decode
# steps, heads), v2 nothing; int8 attention: the Hopper int8 body also
# serves every ragged tile, and the older int8 ragged body nothing; every
# cache write (decode steps, chunks, rounds) goes to the KV-row writer of the
# cache, one launch a layer, and the older appends nothing
PLANES = {
    "bf16": dict(kernels=("paged_attention_sm90", "paged_attention_decode_sm90", "kv_append_sm90",
                          "ragged_paged_attention_sm90", "ragged_paged_attention_decode_sm90"),
                 never=("ragged_paged_attention", "kv_append"), quant="", group=0, kv_quant=""),
    "int8+kv8": dict(kernels=("paged_attention_q8_decode_sm90", "paged_attention_q8_sm90",
                              "kv_append_q8_sm90", "ragged_paged_attention_q8_sm90",
                              "quant_matmul_int8_sm90", "quant_matmul_int8_decode_sm90"),
                     never=("quant_matmul_int8", "kv_append_q8"), quant="int8", group=0,
                     kv_quant="int8"),
    "int4g128+kv8": dict(kernels=("paged_attention_q8_decode_sm90", "paged_attention_q8_sm90",
                                  "kv_append_q8_sm90", "ragged_paged_attention_q8_sm90",
                                  "quant_matmul_int4_sm90", "quant_matmul_int4_decode_sm90"),
                         never=("quant_matmul_int4", "kv_append_q8"), quant="int4", group=128,
                         kv_quant="int8"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def log_resource_usage(lib: Path, kernel: str) -> bool:
    """Registers, stack (spills) and static shared memory of each
    instantiation of ``kernel`` in a built library, as ``cuobjdump
    -res-usage`` reports them. Returns whether one has a stack or local
    memory (a spill)."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        log(f"  {kernel}: resource usage not measured (no cuobjdump)")
        return False
    out = subprocess.run([str(tool), "-res-usage", str(lib)], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    spills = False
    for name, usage in zip(out, out[1:]):
        if kernel in name and "Function" in name:
            log(f"  {name.strip()[:100]}: {usage.strip()}")
            spills |= any(int(n) > 0 for n in re.findall(r"(?:STACK|LOCAL):(\d+)", usage))
    return spills


def _events_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn`` over ``iters``
    CUDA-event-timed runs. A run is as many back-to-back calls (at most 20)
    as fill about a millisecond, so the host's cost of a launch hides behind
    the card's work wherever the card takes longer than the host; a call of
    a millisecond or more runs alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    reps = max(1, min(20, int(1.0 / max(_events_ms(torch, fn, 1), 0.05))))
    return statistics.median(_events_ms(torch, fn, reps) / reps for _ in range(iters))


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

H, HKV, D, PS, MP = 32, 8, 128, 128, 64  # llama3-8b heads, page_size, pages/seq
SERVE_CONTEXT = 5236  # the serves' longest prompt: the decode step's context in profile_steps
# a ragged round shaped like the serve's: three 512-token chunks at q_offset
# 1024, 2048 and 4096 beside 4 decode rows at SERVE_CONTEXT, in the 2048
# bucket of the 64-row round ((tokens, first position) per row)
SERVE_ROUND = [(512, 1024), (512, 2048), (512, 4096)] + [(1, SERVE_CONTEXT - 1)] * 4


def _cache(torch, gen, dev, n_layers: int, n_pages: int, q8: bool = False):
    """(k, v, k_scales, v_scales): random bf16 pages, or for ``q8`` the same
    random rows quantized as the int8 cache stores them (scales None for
    bf16)."""
    from finchat_tpu_torch.engine.kv_cache import quantize_kv_rows, scale_rows

    shape = (n_layers, n_pages, PS, HKV * D)
    out = []
    for _ in range(2):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
        if not q8:
            out.append((x, None))
            continue
        q, s = quantize_kv_rows(x, HKV)  # s [L, P, PS, HKV]
        planes = torch.zeros((n_layers, n_pages, scale_rows(HKV), PS), device=dev)
        planes[:, :, :HKV] = s.transpose(2, 3)
        out.append((q, planes))
        del x
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _page_table(torch, gen, dev, kv_lens: list[int], n_pages: int):
    """Distinct physical pages per sequence (never the trash page 0)."""
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev).to(torch.int32) + 1
    pt = torch.zeros((len(kv_lens), MP), dtype=torch.int32, device=dev)
    nxt = 0
    for b, n in enumerate(kv_lens):
        k = max(1, -(-n // PS))
        pt[b, :k] = perm[nxt:nxt + k]
        nxt += k
    assert nxt < n_pages
    return pt


def _attention_flops(q_pos_kv: list[tuple[int, int]]) -> float:
    """QK and PV FLOPs for queries given as (position, kv_len) pairs."""
    keys = sum(min(p + 1, kl) for p, kl in q_pos_kv)
    return 4.0 * keys * H * D


def _kv_bytes(tokens: int, q8: bool) -> float:
    """Bytes of K and V for ``tokens`` cached tokens: bf16, or int8 plus
    one fp32 scale per token and KV head."""
    return tokens * HKV * (D + 4) * 2 if q8 else tokens * HKV * D * 2 * 2


def attention_errors(torch, got, want) -> tuple[float, float, bool]:
    """(max abs error, max over output rows of the row's max abs error over
    the row's largest reference value, every row within its limit); a row is
    one token of one head."""
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    ok = bool((diff <= (REL_TOL * scale).clamp(max=ATOL)).all().item())
    return diff.max().item(), (diff / scale.clamp(min=1e-30)).max().item(), ok


def _sdpa_ms(torch, calls) -> float:
    """scaled_dot_product_attention over pre-gathered KV: the summed time of
    ``calls``, each (q [B, H, Sq, D], k, v [B, Hkv, S, D], mask), timed
    together."""
    import torch.nn.functional as F

    def run():
        for q_rows, k_rows, v_rows, mask in calls:
            F.scaled_dot_product_attention(q_rows, k_rows, v_rows, attn_mask=mask,
                                           enable_gqa=True)

    return time_ms(torch, run)


def _gather_dense(torch, cache, pt, layer: int, S: int):
    """Dense bf16 [B, Hkv, S, D] K/V of each sequence's first S tokens
    (dequantized for an int8 cache)."""
    from finchat_tpu_torch.engine.kv_cache import gather_kv_any

    k, v = gather_kv_any(*cache, pt, PS, layer, HKV, dtype=torch.bfloat16)
    return (k[:, :S].permute(0, 2, 1, 3).contiguous(), v[:, :S].permute(0, 2, 1, 3).contiguous())


def check_attention_calls(torch, name: str, calls, want, live, results: list,
                          extra: dict, wrapper_ms: float) -> None:
    """Each prepared attention launch in ``calls`` (the routed kernel first,
    then the older body on the same inputs where the routing picked the
    Hopper one): launched twice (identical outputs), its live rows held
    against ``want``, its dead rows (no key, padding) zero, and its launch
    alone timed; ``wrapper_ms`` (the routed wrapper's time, its host work
    included) goes with the first."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES

    for n, call in enumerate(calls):
        before = dict(LAUNCHES)
        got = call.launch().clone()
        again = call.launch()
        torch.cuda.synchronize()
        moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        if moved != {call.name: 2}:
            fail(f"{name}: expected two launches of {call.name}, launches moved: {moved}")
        same = bool(torch.equal(got, again))
        err, rel, close = attention_errors(torch, got[live], want[live])
        zeros_ok = bool((got[~live] == 0).all().item())
        finite = bool(torch.isfinite(got.float()).all().item())
        log(f"  {name} [{call.name}]: max_abs_err {err:.3e}, row-relative {rel:.3e} (limit per "
            f"row: min({ATOL}, {REL_TOL} * max|want|)), rows without keys zero: {zeros_ok}, "
            f"two launches identical: {same}")
        if not (close and zeros_ok and finite and same):
            fail(f"{name}: {call.name} disagrees with its plain version (row-relative {rel}, "
                 f"zeros {zeros_ok}, finite {finite}, identical {same})")
        del got, again
        ms = time_ms(torch, call.launch)
        routed = dict(wrapper_ms=wrapper_ms) if n == 0 and wrapper_ms is not None else {}
        log(f"  {name} [{call.name}]: kernel {ms:.4f} ms, plain {extra['plain_ms']:.4f} ms, "
            f"sdpa {extra['library_ms']:.4f} ms, bound {extra['bound_ms']:.4f} ms "
            f"({extra['bound_by']})" + (f"; the routed wrapper, its host work included, "
                                         f"{wrapper_ms:.4f} ms" if routed else ""))
        results.append(dict(case=name, kernel=call.name, err=err, rel_err=rel, ms=ms, **extra,
                            **routed))


def check_paged(torch, name, gen, dev, C: int, q_offsets: list[int], kv_lens: list[int],
                results: list, q8: bool = False, launch_plane: str | None = None) -> None:
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.paged_attention import (
        paged_attention_q8_ref,
        paged_attention_ref,
        paged_flash_attention,
        paged_flash_attention_q8,
        prepare_paged,
    )

    B, layer = len(kv_lens), 1
    n_pages = 2 + sum(max(1, -(-n // PS)) for n in kv_lens)
    k_pages, v_pages, k_scales, v_scales = cache = _cache(torch, gen, dev, 2, n_pages, q8)
    pt = _page_table(torch, gen, dev, kv_lens, n_pages)
    q = torch.randn((B, C, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
    q_off = torch.tensor(q_offsets, dtype=torch.int32, device=dev)
    kv = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    kw = dict(page_size=PS, n_kv=HKV)
    kind = "paged_attention_q8" if q8 else "paged_attention"
    scales = dict(k_scales=k_scales, v_scales=v_scales) if q8 else {}

    def wrapper():
        if q8:
            return paged_flash_attention_q8(q, k_pages, v_pages, k_scales, v_scales, pt, q_off,
                                            kv, layer, **kw)
        return paged_flash_attention(q, k_pages, v_pages, pt, q_off, kv, layer, **kw)

    def plain():
        if q8:
            return paged_attention_q8_ref(q, k_pages, v_pages, k_scales, v_scales, pt, q_off,
                                          kv, layer, **kw)
        return paged_attention_ref(q, k_pages, v_pages, pt, q_off, kv, layer, **kw)

    args = (q, k_pages, v_pages, pt, q_off, kv, layer)
    routed = prepare_paged(kind, *args, **kw, **scales)
    calls = [routed]
    if routed.name != kind:  # the older body on the same inputs, launched by name
        calls.append(prepare_paged(kind, *args, **kw, **scales, route=False))
    before = LAUNCHES[routed.name]
    wrapper()
    torch.cuda.synchronize()
    if LAUNCHES[routed.name] != before + 1:
        fail(f"{name}: the wrapper did not launch {routed.name}, the kernel its rule names")
    want = plain()
    S = max(kv_lens)
    k_rows, v_rows = _gather_dense(torch, cache, pt, layer, S)
    pos = torch.arange(S, device=dev)
    qp = q_off[:, None] + torch.arange(C, device=dev)[None, :]  # [B, C]
    mask = (pos[None, None, :] <= qp[:, :, None]) & (pos[None, None, :] < kv[:, None, None])
    lib_ms = _sdpa_ms(torch, [(q.transpose(1, 2).contiguous(), k_rows, v_rows, mask[:, None])])
    del k_rows, v_rows
    io_bytes = q.numel() * 2 * 2 + pt.numel() * 4 + B * 8
    flops = _attention_flops([(o + i, kl) for o, kl in zip(q_offsets, kv_lens) for i in range(C)])
    b_ms, b_by = bound_ms(_kv_bytes(sum(kv_lens), q8) + io_bytes, flops)
    extra = dict(plain_ms=time_ms(torch, plain), bound_ms=b_ms, bound_by=b_by,
                 library_ms=lib_ms)
    if launch_plane is not None:  # the window its launches are read from
        extra["launch_plane"] = launch_plane
    check_attention_calls(torch, name, calls, want, kv > 0, results, extra,
                          time_ms(torch, wrapper))
    del k_pages, v_pages, k_scales, v_scales, cache, calls, routed
    torch.cuda.empty_cache()


def _append_lanes(torch, gen, dev, B: int, P: int):
    """Page table, positions and validity of the append cases: positions
    inside each lane's first 8 pages; invalid lanes (every 8th) at distinct
    offsets so their trash-page writes never collide."""
    kv_lens = [int(x) for x in torch.randint(1, 4096, (B,), generator=gen, device=dev)]
    pt = torch.zeros((B, MP), dtype=torch.int32, device=dev)
    pt[:, :8] = (torch.arange(B * 8, device=dev, dtype=torch.int32).reshape(B, 8) % (P - 1)) + 1
    pos = torch.tensor([(n % (8 * PS)) if b % 8 else b for b, n in enumerate(kv_lens)],
                       dtype=torch.int32, device=dev)
    n_valid = torch.tensor([0 if b % 8 == 0 else 1 for b in range(B)], dtype=torch.int32,
                           device=dev)
    return pt, pos, n_valid


def check_append(torch, gen, dev, results: list) -> None:
    """K2 bit-exact against its plain version at the serving cache; its
    prepared launch timed alone, one launch of 20 in a CUDA graph (as the
    ``index_put_`` yardstick), the wrapper's time beside it."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.kv_append import (
        paged_kv_append,
        paged_kv_append_ref,
        prepare_append,
    )
    from finchat_tpu_torch.tools.qmm_decode_diag import graph_ms

    B, L, P = 64, 32, 512  # the serving cache: [32, 512, 128, 1024]
    HD = HKV * D
    k_pages = torch.zeros((L, P, PS, HD), dtype=torch.bfloat16, device=dev)
    v_pages = torch.zeros_like(k_pages)
    pt, pos, n_valid = _append_lanes(torch, gen, dev, B, P)
    kv_new = torch.randn((B, 1, 2 * HD), generator=gen, device=dev, dtype=torch.bfloat16)
    layer = 17
    before = LAUNCHES["kv_append"]
    paged_kv_append(kv_new, k_pages, v_pages, pt, pos, n_valid, layer, page_size=PS)
    torch.cuda.synchronize()
    assert LAUNCHES["kv_append"] == before + 1
    k_ref, v_ref = torch.zeros_like(k_pages), torch.zeros_like(v_pages)
    paged_kv_append_ref(kv_new, k_ref, v_ref, pt, pos, n_valid, layer, page_size=PS)
    exact = bool(torch.equal(k_pages, k_ref) and torch.equal(v_pages, v_ref))
    err = max((k_pages.float() - k_ref.float()).abs().max().item(),
              (v_pages.float() - v_ref.float()).abs().max().item())
    log(f"  kv_append: bit-exact {exact} (max_abs_err {err:.3e})")
    if not exact:
        fail("kv_append: kernel is not bit-exact against its plain version")

    def wrapper():
        paged_kv_append(kv_new, k_pages, v_pages, pt, pos, n_valid, layer, page_size=PS)

    def plain():
        paged_kv_append_ref(kv_new, k_ref, v_ref, pt, pos, n_valid, layer, page_size=PS)

    # yardstick: index_put_ of the same rows at their (page, row) addresses
    phys = torch.where(n_valid > 0, pt.long().gather(1, (pos.long() // PS)[:, None])[:, 0], 0)
    off = pos.long() % PS
    k_rows, v_rows = kv_new[:, 0, :HD].contiguous(), kv_new[:, 0, HD:].contiguous()

    def library():
        k_ref[layer].index_put_((phys, off), k_rows)
        v_ref[layer].index_put_((phys, off), v_rows)

    ms = graph_ms(prepare_append(kv_new, k_pages, v_pages, pt, pos, n_valid, layer,
                                 page_size=PS).launch)
    wrapper_ms = time_ms(torch, wrapper)
    plain_ms = time_ms(torch, plain)
    lib_ms = graph_ms(library)
    moved = 2 * kv_new.numel() * 2 + B * (4 + 4 + 4)  # rows in, rows out, pos/valid/table
    b_ms, b_by = bound_ms(moved, 0.0)
    log(f"  kv_append: kernel {ms:.4f} ms (a launch of 20 in a CUDA graph; the wrapper, its "
        f"host work included, {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, index_put_ "
        f"{lib_ms:.4f} ms (graph), bound {b_ms:.6f} ms ({b_by})")
    results.append(dict(case="kv_append", kernel="kv_append", err=err, rel_err=None, ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                        wrapper_ms=wrapper_ms))
    del k_pages, v_pages, k_ref, v_ref
    torch.cuda.empty_cache()


def check_append_q8(torch, gen, dev, results: list) -> None:
    """K5 bit-exact against its plain version at the serving int8 cache;
    timed as K2 is (no library call quantizes and scatters)."""
    from finchat_tpu_torch.engine.kv_cache import scale_rows
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.kv_append import (
        paged_kv_append_q8,
        paged_kv_append_q8_ref,
        prepare_append_q8,
    )
    from finchat_tpu_torch.tools.qmm_decode_diag import graph_ms

    B, L, P = 64, 32, 512  # the serving int8 cache: [32, 512, 128, 1024] + scale planes
    HD = HKV * D
    k_pages = torch.zeros((L, P, PS, HD), dtype=torch.int8, device=dev)
    v_pages = torch.zeros_like(k_pages)
    k_scales = torch.zeros((L, P, scale_rows(HKV), PS), device=dev)
    v_scales = torch.zeros_like(k_scales)
    cache = (k_pages, v_pages, k_scales, v_scales)
    pt, pos, n_valid = _append_lanes(torch, gen, dev, B, P)
    kv_new = torch.randn((B, 1, 2 * HD), generator=gen, device=dev, dtype=torch.bfloat16)
    kv_new[5, 0, :D] = 0  # an all-zero head: scale 1/127
    layer = 17
    kw = dict(page_size=PS, n_kv=HKV)
    before = LAUNCHES["kv_append_q8"]
    paged_kv_append_q8(kv_new, *cache, pt, pos, n_valid, layer, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["kv_append_q8"] == before + 1
    ref = tuple(torch.zeros_like(t) for t in cache)
    paged_kv_append_q8_ref(kv_new, *ref, pt, pos, n_valid, layer, **kw)
    exact = all(bool(torch.equal(a, b)) for a, b in zip(cache, ref))
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(cache, ref))
    log(f"  kv_append_q8: bit-exact {exact}, pages and scale planes (max_abs_err {err:.3e})")
    if not exact:
        fail("kv_append_q8: kernel is not bit-exact against its plain version")

    def wrapper():
        paged_kv_append_q8(kv_new, *cache, pt, pos, n_valid, layer, **kw)

    def plain():
        paged_kv_append_q8_ref(kv_new, *ref, pt, pos, n_valid, layer, **kw)

    ms = graph_ms(prepare_append_q8(kv_new, *cache, pt, pos, n_valid, layer, **kw).launch)
    wrapper_ms = time_ms(torch, wrapper)
    plain_ms = time_ms(torch, plain)
    # bf16 rows in, int8 rows and fp32 scales out, pos/valid/table entries
    moved = kv_new.numel() * 2 + kv_new.numel() + B * 2 * HKV * 4 + B * (4 + 4 + 4)
    b_ms, b_by = bound_ms(moved, 0.0)
    log(f"  kv_append_q8: kernel {ms:.4f} ms (a launch of 20 in a CUDA graph; the wrapper, its "
        f"host work included, {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, library none, "
        f"bound {b_ms:.6f} ms ({b_by})")
    results.append(dict(case="kv_append_q8", kernel="kv_append_q8", err=err, rel_err=None,
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        wrapper_ms=wrapper_ms))
    del cache, ref, k_pages, v_pages, k_scales, v_scales
    torch.cuda.empty_cache()


def _kv_write_cases(torch, gen, dev, n_pages: int):
    """The KV-row writer's cases at llama3-8b's KV width, as (name, plan, K,
    V, padding lanes share trash rows): a decode step of 64 lanes (the
    append cases' lanes, every 8th invalid at its own offset; K and V the
    halves of one fused row, each with a row stride of 2 * HD), the 4 x 512
    chunk at q_offset 2048, and the serve-shaped round (``SERVE_ROUND``:
    1,540 tokens padded to the 2,048 bucket of a 64-row round, the padding
    tokens all on the trash page's row 0)."""
    from finchat_tpu_torch.ops.kv_append import plan_kv_rows, plan_kv_rows_ragged

    HD = HKV * D
    i32 = dict(dtype=torch.int32, device=dev)
    bf = dict(generator=gen, device=dev, dtype=torch.bfloat16)
    pt, pos, n_valid = _append_lanes(torch, gen, dev, 64, n_pages)
    fused = torch.randn((64, 2 * HD), **bf)
    yield "decode", plan_kv_rows(pt, pos, n_valid, 1, PS), fused[:, :HD], fused[:, HD:], False
    pt = _page_table(torch, gen, dev, [2560] * 4, n_pages)
    plan = plan_kv_rows(pt, torch.full((4,), 2048, **i32), torch.full((4,), 512, **i32), 512, PS)
    k, v = torch.randn((2048, HD), **bf), torch.randn((2048, HD), **bf)
    yield "chunk_4x512_q2048", plan, k, v, False
    R, T = 64, 2048
    page_rows = torch.zeros((R, MP), **i32)
    page_rows[:len(SERVE_ROUND)] = _page_table(torch, gen, dev, [p0 + q for q, p0 in SERVE_ROUND],
                                               n_pages)
    tok_row = [r for r, (q, _p0) in enumerate(SERVE_ROUND) for _ in range(q)]
    tok_pos = [p0 + i for q, p0 in SERVE_ROUND for i in range(q)]
    pad = T - len(tok_row)
    plan = plan_kv_rows_ragged(page_rows, torch.tensor(tok_row + [R] * pad, **i32),
                               torch.tensor(tok_pos + [0] * pad, **i32), PS)
    k, v = torch.randn((T, HD), **bf), torch.randn((T, HD), **bf)
    yield "round_serve", plan, k, v, True


def check_kv_write(torch, dev, results: list, q8: bool, launch_plane: str | None = None,
                   prefix: str = "") -> None:
    """The KV-row writer — K2 and K5 redesigned, every cache write of a
    serve — at the serving cache, per case of ``_kv_write_cases``: the
    wrapper launches its entry once, the cache is bit-exact against the
    plain version (the chunk scatter) on the same inputs (every layer and
    page; where padding lanes share trash rows, every page but the trash
    page 0), a second launch leaves it identical; the launch is timed as
    one of 20 in a CUDA graph, as are the plain version and, for the bf16
    cache, ``index_put_`` of the same rows, the routed wrapper's time (host
    work included) by events beside it. Its own generator: the draws of
    the cases after it stay as they were. ``launch_plane`` names the
    main-path window whose launches its rows report, ``prefix`` their
    cases'."""
    from finchat_tpu_torch.engine.kv_cache import scale_rows
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.kv_append import (
        paged_kv_write,
        paged_kv_write_ref,
        prepare_kv_write,
    )
    from finchat_tpu_torch.tools.qmm_decode_diag import graph_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(2469 if q8 else 2468)
    L, P, HD, layer = 32, 512, HKV * D, 17  # the serving cache: [32, 512, 128, 1024]
    kernel = "kv_append_q8_sm90" if q8 else "kv_append_sm90"
    dtype = torch.int8 if q8 else torch.bfloat16

    def cache():
        pages = [torch.zeros((L, P, PS, HD), dtype=dtype, device=dev) for _ in range(2)]
        planes = [torch.zeros((L, P, scale_rows(HKV), PS), device=dev) for _ in range(2)] if q8 \
            else [None, None]
        return pages + planes

    got, ref = cache(), cache()
    label = prefix + ("kv_write_q8" if q8 else "kv_write")
    plane = dict(launch_plane=launch_plane) if launch_plane else {}
    for name, plan, k, v, collide in _kv_write_cases(torch, gen, dev, P):
        for t in got + ref:
            if t is not None:
                t.zero_()
        kw = dict(n_kv=HKV, k_scales=got[2], v_scales=got[3])
        kw_ref = dict(n_kv=HKV, k_scales=ref[2], v_scales=ref[3])
        before = dict(LAUNCHES)
        paged_kv_write(plan.rows, k, v, got[0], got[1], layer, **kw)
        torch.cuda.synchronize()
        moved = {n: LAUNCHES[n] - before[n] for n in LAUNCHES if LAUNCHES[n] != before[n]}
        if moved != {kernel: 1}:
            fail(f"{label}_{name}: expected one launch of {kernel}, launches moved: {moved}")
        paged_kv_write_ref(plan, k, v, ref[0], ref[1], layer, **kw_ref)
        live = slice(1, None) if collide else slice(None)
        pairs = [(a, b) for a, b in zip(got, ref) if a is not None]
        exact = all(bool(torch.equal(a[:, live], b[:, live])) for a, b in pairs)
        err = max((a[layer, live].float() - b[layer, live].float()).abs().max().item()
                  for a, b in pairs)
        first = [a[layer].clone() for a, _b in pairs]
        call = prepare_kv_write(plan.rows, k, v, got[0], got[1], layer, **kw)
        call.launch()
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a[layer, live], f[live]))
                   for (a, _b), f in zip(pairs, first))
        del first
        N = plan.rows.numel()
        log(f"  {label}_{name} [{kernel}]: {N} rows, bit-exact {exact} against the chunk "
            f"scatter (pages{' and scale planes' if q8 else ''}"
            f"{', every page but the trash page' if collide else ''}; max_abs_err {err:.3e}), "
            f"two launches identical: {same}")
        if not (exact and same):
            fail(f"{label}_{name}: {kernel} disagrees with its plain version "
                 f"(bit-exact {exact}, identical {same})")

        def wrapper():
            paged_kv_write(plan.rows, k, v, got[0], got[1], layer, **kw)

        def plain():
            paged_kv_write_ref(plan, k, v, ref[0], ref[1], layer, **kw_ref)

        ms = graph_ms(call.launch)
        wrapper_ms = time_ms(torch, wrapper)
        plain_ms = graph_ms(plain)
        lib_ms = None
        if not q8:  # yardstick: index_put_ of the same rows into each layer's [P * PS, HD] view
            rows_l = plan.rows.long()
            k_view, v_view = ref[0][layer].view(-1, HD), ref[1][layer].view(-1, HD)

            def library():
                k_view.index_put_((rows_l,), k)
                v_view.index_put_((rows_l,), v)

            lib_ms = graph_ms(library)
        # K and V rows in (bf16), written (bf16, or int8 and an fp32 scale a
        # head), and each token's row index
        out_bytes = 2 * HD + 2 * HKV * 4 if q8 else 2 * HD * 2
        b_ms, b_by = bound_ms(N * (2 * HD * 2 + out_bytes + 4), 0.0)
        log(f"  {label}_{name} [{kernel}]: kernel {ms:.4f} ms (a launch of 20 in a CUDA graph; "
            f"the wrapper, its host work included, {wrapper_ms:.4f} ms), plain {plain_ms:.4f} "
            f"ms (graph), " + (f"index_put_ {lib_ms:.4f} ms (graph)" if lib_ms is not None
                               else "library none") + f", bound {b_ms:.6f} ms ({b_by})")
        results.append(dict(case=f"{label}_{name}", kernel=kernel, err=err, rel_err=None, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                            wrapper_ms=wrapper_ms, **plane))
        del plan, k, v, call
    del got, ref
    torch.cuda.empty_cache()


def _ragged_sdpa_calls(torch, q, k_rows, v_rows, kv, spans, rows):
    """scaled_dot_product_attention's calls on the same work as ``rows`` of
    a ragged round (each 512 tokens long, or one token): the prefill rows as
    one call (B rows, Sq=512), the decode rows as another (Sq=1), each over
    its rows' KV padded to the longest of them and masked. Token offsets
    follow the packing (rows in order from token 0)."""
    starts = [sum(q_len for q_len, _p in spans[:r]) for r in range(len(spans))]
    pre = [r for r in rows if spans[r][0] > 1]
    dec = [r for r in rows if spans[r][0] == 1]
    dev = q.device
    calls = []
    if pre:
        s_pre = max(int(kv[r]) for r in pre)
        q_pre = torch.stack([q[starts[r]:starts[r] + 512] for r in pre]).transpose(1, 2)
        qpos = torch.tensor([[spans[r][1] + i for i in range(512)] for r in pre], device=dev)
        pos = torch.arange(s_pre, device=dev)
        idx = torch.tensor(pre, device=dev)
        mask = (pos[None, None, :] <= qpos[:, :, None]) & (pos[None, None, :] < kv[idx, None, None])
        calls.append((q_pre.contiguous(), k_rows[idx, :, :s_pre].contiguous(),
                      v_rows[idx, :, :s_pre].contiguous(), mask[:, None]))
    if dec:
        s_dec = max(int(kv[r]) for r in dec)
        idx = torch.tensor(dec, device=dev)
        q_dec = q[torch.tensor([starts[r] for r in dec], device=dev), :, None, :]
        mask = torch.arange(s_dec, device=dev)[None, None, None, :] < kv[idx, None, None, None]
        calls.append((q_dec.contiguous(), k_rows[idx, :, :s_dec].contiguous(),
                      v_rows[idx, :, :s_dec].contiguous(), mask))
    return calls


def _ragged_work(spans, kv_lens, rows, q8: bool, io: float):
    """(bound ms, bound by) of the work of ``rows`` of a round: their KV read
    once and ``io`` bytes of queries, outputs and descriptors; their
    tokens' causal FLOPs."""
    flops = _attention_flops([(p0 + i, kv_lens[r]) for r in rows
                              for q_len, p0 in [spans[r]] for i in range(q_len)])
    return bound_ms(_kv_bytes(sum(kv_lens[r] for r in rows), q8) + io, flops)


def check_ragged(torch, gen, dev, results: list, name: str, spans, T: int, R: int = 64,
                 q8: bool = False, launch_plane: str | None = None,
                 with_older: bool = True) -> None:
    """A ragged round (``spans``: (tokens, first position) per row, rows
    padded with empty ones to ``R``, tokens to ``T``) through the routed
    launches against the plain version; over the bf16 cache the pair of
    Hopper entries, each held on its own rows and timed alone, with the
    older body (K3) by name beside them on the same inputs (``with_older``
    False: the routed launches alone). ``launch_plane`` names the main-path
    window whose launches its rows report."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES, PreparedSeq
    from finchat_tpu_torch.ops.ragged_paged_attention import (
        prepare_ragged,
        ragged_flash_attention,
        ragged_flash_attention_q8,
        ragged_paged_attention_ref,
    )

    kind = "ragged_paged_attention_q8" if q8 else "ragged_paged_attention"
    layer = 1
    spans = list(spans) + [(0, 0)] * (R - len(spans))
    kv_lens = [q_len + p0 for q_len, p0 in spans]
    n_pages = 2 + sum(max(1, -(-n // PS)) for n in kv_lens)
    k_pages, v_pages, k_scales, v_scales = cache = _cache(torch, gen, dev, 2, n_pages, q8)
    pt = _page_table(torch, gen, dev, kv_lens, n_pages)
    tok_row, tok_pos = [], []
    for r, (q_len, p0) in enumerate(spans):
        tok_row += [r] * q_len
        tok_pos += list(range(p0, p0 + q_len))
    n_real = len(tok_row)
    tok_row += [R] * (T - n_real)
    tok_pos += [0] * (T - n_real)
    tr = torch.tensor(tok_row, dtype=torch.int32, device=dev)
    tp = torch.tensor(tok_pos, dtype=torch.int32, device=dev)
    kv = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = torch.randn((T, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
    kw = dict(page_size=PS, n_kv=HKV)
    scales = dict(k_scales=k_scales, v_scales=v_scales) if q8 else {}

    def wrapper():
        if q8:
            return ragged_flash_attention_q8(q, k_pages, v_pages, k_scales, v_scales, pt, tr,
                                             tp, kv, layer, **kw)
        return ragged_flash_attention(q, k_pages, v_pages, pt, tr, tp, kv, layer, **kw)

    def plain(idx=None):
        """The plain version on every token, or on the tokens ``idx``."""
        qq, rr, pp = (q, tr, tp) if idx is None else (q[idx], tr[idx], tp[idx])
        return ragged_paged_attention_ref(qq, k_pages, v_pages, pt, rr, pp, kv, layer,
                                          k_scales=k_scales, v_scales=v_scales, **kw)

    args = (q, k_pages, v_pages, pt, tr, tp, kv, layer)
    routed = prepare_ragged(kind, *args, **kw, **scales)
    before = dict(LAUNCHES)
    wrapper()
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    if moved != {p.name: 1 for p in routed.parts}:
        fail(f"{name}: the wrapper launched {moved}, not the kernels its rule names "
             f"({routed.name})")
    want = plain()
    S = max(kv_lens)
    k_rows, v_rows = _gather_dense(torch, cache, pt, layer, S)
    live_rows = [r for r in range(R) if spans[r][0] > 0]
    lib_ms = _sdpa_ms(torch, _ragged_sdpa_calls(torch, q, k_rows, v_rows, kv, spans, live_rows))
    # q read and out written for every token of the bucket, the page table,
    # tok_row and tok_pos, kv_len
    io = q.numel() * 2 * 2 + pt.numel() * 4 + T * 8 + R * 4
    b_ms, b_by = _ragged_work(spans, kv_lens, live_rows, q8, io)
    plain_ms = time_ms(torch, plain, iters=3, warmup=1)
    extra = dict(plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    if launch_plane is not None:
        extra["launch_plane"] = launch_plane
    live = torch.arange(T, device=dev) < n_real
    wrapper_ms = time_ms(torch, wrapper)
    if isinstance(routed, PreparedSeq):
        check_ragged_pair(torch, name, routed, want, live, tr, spans, kv_lens, R, n_real, T,
                          (q, k_rows, v_rows, kv), plain, results, wrapper_ms, extra)
        calls = [prepare_ragged(kind, *args, **kw, **scales, route=False)] if with_older else []
        if calls:
            check_attention_calls(torch, name, calls, want, live, results, extra, None)
    else:
        calls = [routed]
        if routed.name != kind and with_older:  # the older body on the same inputs, by name
            calls.append(prepare_ragged(kind, *args, **kw, **scales, route=False))
        check_attention_calls(torch, name, calls, want, live, results, extra, wrapper_ms)
    del k_rows, v_rows, k_pages, v_pages, k_scales, v_scales, cache, calls, routed
    torch.cuda.empty_cache()


def check_ragged_pair(torch, name, pair, want, live, tr, spans, kv_lens, R: int, n_real: int,
                      T: int, dense, plain, results: list, wrapper_ms: float,
                      whole: dict) -> None:
    """A bf16 round's pair of launches (the prefill tiles, then the
    one-token rows, into one output): launched twice, identical; the
    round's live rows held against the plain version, padding zero; then
    each entry on the rows it writes — its error, its launch alone timed,
    its own bound, the plain version and SDPA on its rows — and the pair's
    time together."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES

    q, k_rows, v_rows, kv = dense
    before = dict(LAUNCHES)
    got = pair.launch().clone()
    again = pair.launch()
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    if moved != {p.name: 2 for p in pair.parts}:
        fail(f"{name}: expected two launches of each of {pair.name}, launches moved: {moved}")
    same = bool(torch.equal(got, again))
    err, rel, close = attention_errors(torch, got[live], want[live])
    zeros_ok = bool((got[~live] == 0).all().item())
    finite = bool(torch.isfinite(got.float()).all().item())
    log(f"  {name} [{pair.name}]: max_abs_err {err:.3e}, row-relative {rel:.3e} (limit per "
        f"row: min({ATOL}, {REL_TOL} * max|want|)), padding zero: {zeros_ok}, two launches "
        f"identical: {same}")
    if not (close and zeros_ok and finite and same):
        fail(f"{name}: {pair.name} disagrees with its plain version (row-relative {rel}, "
             f"zeros {zeros_ok}, finite {finite}, identical {same})")
    pair_ms = time_ms(torch, pair.launch)
    log(f"  {name} [{pair.name}]: the pair {pair_ms:.4f} ms (K3's bound {whole['bound_ms']:.4f} "
        f"ms, {whole['bound_by']}; sdpa {whole['library_ms']:.4f} ms); the routed wrapper, its "
        f"host work included, {wrapper_ms:.4f} ms")
    one = torch.tensor([q_len == 1 for q_len, _p in spans] + [False], device=got.device)
    dec_tok = one[tr.long().clamp(max=R)] & (tr < R)
    rows = {"ragged_paged_attention_sm90": [r for r in range(R) if spans[r][0] > 1],
            "ragged_paged_attention_decode_sm90": [r for r in range(R) if spans[r][0] == 1]}
    for part in pair.parts:
        decode = part.name.endswith("_decode_sm90")
        mine = dec_tok if decode else ~dec_tok  # the prefill entry also zeroes the padding
        idx = torch.nonzero(mine & live).flatten()
        p_err, p_rel, _ok = attention_errors(torch, got[idx], want[idx])
        ms = time_ms(torch, part.launch)
        p_plain = time_ms(torch, lambda: plain(idx), iters=3, warmup=1)
        lib = _sdpa_ms(torch, _ragged_sdpa_calls(torch, q, k_rows, v_rows, kv, spans,
                                                 rows[part.name]))
        # its tokens' q read and out written (the prefill entry also writes
        # the padding's zeros), its rows' page-table rows and descriptors
        n_tok, pad = int(idx.numel()), 0 if decode else T - n_real
        io = ((2 * n_tok + pad) * H * D * 2 + len(rows[part.name]) * (MP + 3) * 4
              + (n_tok + pad) * 8)
        b_ms, b_by = _ragged_work(spans, kv_lens, rows[part.name], False, io)
        log(f"  {name} [{part.name}]: its rows max_abs_err {p_err:.3e}, row-relative "
            f"{p_rel:.3e}; kernel {ms:.4f} ms alone, plain {p_plain:.4f} ms, sdpa {lib:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        row = dict(case=name, kernel=part.name, err=p_err, rel_err=p_rel, ms=ms,
                   plain_ms=p_plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                   pair_ms=pair_ms, wrapper_ms=wrapper_ms)
        if "launch_plane" in whole:
            row["launch_plane"] = whole["launch_plane"]
        results.append(row)


def check_qmm(torch, name: str, gen, dev, M: int, K: int, N: int, mode: str, group: int,
              out_f32: bool, results: list, launch_plane: str | None = None,
              with_v2: bool = True) -> None:
    """The fused dequant matmul against its plain version at one shape,
    through the wrapper (which must pick the kernel ``kernel_for`` names).
    Where that is a Hopper kernel, v2 is also held and timed on the same
    inputs, launched by its own name. Each kernel launches twice with
    identical outputs; the kernels' and the library call's times are those
    of one launch of 20 in a CUDA graph (``graph_ms``), the routed
    wrapper's (host work included) and the plain version's by CUDA events.
    ``launch_plane`` names the main-path window whose launches the row
    reports (the serving plane of its mode by default). ``with_v2`` False
    holds and times the routed kernel alone."""
    from finchat_tpu_torch.models.quant import dequantize, quantize, quantize_int4
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.quant_matmul import (
        kernel_for,
        prepare,
        quant_matmul_int4,
        quant_matmul_int8,
        quant_matmul_ref,
    )
    from finchat_tpu_torch.tools.qmm_decode_diag import graph_ms

    w = torch.randn((K, N), generator=gen, device=dev, dtype=torch.bfloat16).mul_(K ** -0.5)
    qt = quantize_int4(w, group) if mode == "int4" else quantize(w)
    del w
    x = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
    out_dtype = torch.float32 if out_f32 else None
    routed = kernel_for(mode, M, K, N, group or K, out_f32)
    fn = quant_matmul_int4 if mode == "int4" else quant_matmul_int8

    def plain():
        return quant_matmul_ref(x, qt, out_dtype=out_dtype)

    want = plain()
    w_deq = dequantize(qt, torch.bfloat16)
    if out_f32:
        limit = K * QMM_F32_TOL * (x.float().abs() @ w_deq.float().abs())
        how = f"per element {K} * 2^-22 * (|x| @ |w|)"
    else:
        limit = QMM_ROW_TOL * want.float().abs().amax(-1, keepdim=True)
        how = "per row 2^-7 * max|want row|"
    plain_ms = time_ms(torch, plain)
    if out_f32:
        lib_ms = graph_ms(lambda: torch.mm(x, w_deq, out_dtype=torch.float32))
    else:
        lib_ms = graph_ms(lambda: torch.matmul(x, w_deq))
    moved = (x.numel() * 2 + qt.q.numel() + qt.scale.numel() * 4
             + M * N * (4 if out_f32 else 2))
    b_ms, b_by = bound_ms(moved, 2.0 * M * K * N)
    plane = "int4g128+kv8" if mode == "int4" else "int8+kv8"
    v2 = f"quant_matmul_{mode}"
    for kname in (routed, v2) if routed != v2 and with_v2 else (routed,):
        if kname == routed:  # the wrapper launches what kernel_for names
            before = dict(LAUNCHES)
            fn(x, qt.q, qt.scale, out_dtype=out_dtype)
            torch.cuda.synchronize()
            moved_by = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
            if set(moved_by) != {kname}:
                fail(f"{name}: expected the wrapper to launch {kname}, launches moved: {moved_by}")
        call = prepare(kname, x, qt.q, qt.scale, out_dtype=out_dtype)
        outs = []
        for _ in range(2):
            before = dict(LAUNCHES)
            outs.append(call.launch().clone())
            torch.cuda.synchronize()
            if {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} != \
                    {kname: 1}:
                fail(f"{name}: a launch of {kname} was not counted once")
        got = outs[0]
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        finite = bool(torch.isfinite(got.float()).all().item())
        worst = (diff / limit.clamp(min=1e-30)).max().item()
        same = torch.equal(outs[0], outs[1])
        log(f"  {name} [{kname}]: max_abs_err {err:.3e}, worst error / limit {worst:.3f} "
            f"({how}), two launches identical: {same}")
        if not (worst <= 1.0 and finite and same):
            fail(f"{name}: {kname} disagrees with its plain version (error / limit {worst}) "
                 f"or with itself (identical: {same})")
        del got, diff, outs
        ms = graph_ms(call.launch)
        row = dict(case=name, kernel=kname, plane=launch_plane or plane, err=err, rel_err=worst,
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        if launch_plane:
            row["launch_plane"] = launch_plane
        extra = ""
        if kname == routed:
            row["wrapper_ms"] = time_ms(torch, lambda: fn(x, qt.q, qt.scale, out_dtype=out_dtype))
            extra = f" (the routed wrapper, host work included: {row['wrapper_ms']:.4f} ms)"
        log(f"  {name} [{kname}]: kernel {ms:.4f} ms{extra}, plain {plain_ms:.4f} ms, "
            f"torch.{'mm' if out_f32 else 'matmul'} (bf16 weight) {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), share {b_ms / ms:.2f}")
        results.append(row)
        del call
    del qt, w_deq, x, want, limit
    torch.cuda.empty_cache()


def _causal_pairs(q_offsets: list[int], Sq: int, kv_lens: list[int]) -> int:
    """(query, key) pairs a causal attention with these descriptors needs."""
    return sum(min(o + i + 1, kl) for o, kl in zip(q_offsets, kv_lens) for i in range(Sq))


def grad_errors(torch, got, want) -> tuple[float, float, float]:
    """(max abs error, ||got - want|| / ||want||, worst per-row error over
    its limit 2^-5 * max(row max, 2^-10 * tensor max)); a row is one token
    of one head."""
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
    diff = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp(min=GRAD_ROW_FLOOR * want.abs().max().item())
    return diff.max().item(), rel, (diff / (GRAD_ROW_TOL * scale).clamp(min=1e-30)).max().item()


def check_flash(torch, name, gen, dev, B: int, Sq: int, Sk: int, q_offsets: list[int],
                kv_lens: list[int], results: list, backward: bool = False,
                launch_plane: str | None = None) -> None:
    """K7 against its plain version at one causal shape: the forward (out
    and log-sum-exp) through the kernel ``flash_kernel_for`` names, and the
    older forward by name beside it where that is another; or with
    ``backward`` the backward ``flash_bwd_kernel_for`` names on the routed
    forward's out and lse, and the older backward by name beside it where
    that is another. Each forward launches twice over an output and lse
    filled with NaN, each backward over dq, dk and dv filled with NaN
    (identical results); a forward's prepared launch is timed alone, a
    backward's as one launch of 20 in a CUDA graph, the routed wrapper's
    time beside it. ``launch_plane`` names the main-path window whose
    launches the row reports (default: the train phase's)."""
    import torch.nn.functional as F

    from finchat_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_fwd,
        flash_attention_ref,
        prepare_flash,
        prepare_flash_bwd,
    )
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.refs import mha_reference
    from finchat_tpu_torch.tools.qmm_decode_diag import graph_ms

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    plane = dict(launch_plane=launch_plane) if launch_plane else {}
    q, k, v, dout = rnd(B, Sq, H, D), rnd(B, Sk, HKV, D), rnd(B, Sk, HKV, D), rnd(B, Sq, H, D)
    qo = torch.tensor(q_offsets, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    routed = prepare_flash(q, k, v, qo, kl, causal=True, scale=scale)
    before = LAUNCHES[routed.name]
    out, lse = flash_attention_fwd(q, k, v, qo, kl, causal=True, scale=scale)
    torch.cuda.synchronize()
    if LAUNCHES[routed.name] != before + 1:
        fail(f"{name}: the wrapper did not launch {routed.name}, the kernel its rule names")
    pairs = _causal_pairs(q_offsets, Sq, kv_lens)
    # SDPA's own causal mask is top-left aligned: give it the mask when the
    # queries sit at an offset
    pos = torch.arange(Sk, device=dev)
    qpos = qo[:, None] + torch.arange(Sq, device=dev)[None, :]
    mask = ((pos[None, None, :] <= qpos[:, :, None])
            & (pos[None, None, :] < kl[:, None, None]))[:, None]
    square = Sq == Sk and not any(q_offsets) and all(n == Sk for n in kv_lens)
    sdpa_kw = dict(is_causal=True) if square else dict(attn_mask=mask)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    io = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4 + B * 8
    if not backward:
        calls = [routed]
        if routed.name != "flash_attention":  # the older forward on the same inputs, by name
            calls.append(prepare_flash(q, k, v, qo, kl, causal=True, scale=scale,
                                       kernel="flash_attention"))

        def plain():
            return flash_attention_ref(q, k, v, q_offset=qo, kv_len=kl, causal=True)

        def library():
            F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_kw)

        want, want_lse = plain()
        flops = 4.0 * pairs * H * D
        b_ms, b_by = bound_ms(io, flops)
        plain_ms = time_ms(torch, plain, iters=5, warmup=1)
        lib_ms = time_ms(torch, library)
        wrapper_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, qo, kl, causal=True,
                                                                scale=scale))
        for n, call in enumerate(calls):
            got = []
            for _ in range(2):
                call.out.fill_(float("nan"))
                call.aux.fill_(float("nan"))
                b4 = dict(LAUNCHES)
                got.append((call.launch().clone(), call.aux.clone()))
                torch.cuda.synchronize()
                if {kk: LAUNCHES[kk] - b4[kk] for kk in LAUNCHES if LAUNCHES[kk] != b4[kk]} != \
                        {call.name: 1}:
                    fail(f"{name}: a launch of {call.name} was not counted once")
            (o1, l1), (o2, l2) = got
            same = bool(torch.equal(o1, o2) and torch.equal(l1, l2))
            err, rel, close = attention_errors(torch, o1, want)
            lse_err = (l1 - want_lse).abs().max().item()
            finite = bool(torch.isfinite(o1.float()).all().item() and torch.isfinite(l1).all())
            log(f"  {name} [{call.name}]: max_abs_err {err:.3e}, row-relative {rel:.3e} (limit "
                f"per row: min({ATOL}, {REL_TOL} * max|want|)), lse max_abs_err {lse_err:.3e} "
                f"(limit 1e-3), two launches identical: {same}")
            if not (close and finite and lse_err <= 1e-3 and same):
                fail(f"{name}: {call.name} disagrees with its plain version (row-relative "
                     f"{rel}, lse {lse_err}, finite {finite}) or with itself ({same})")
            del got, o1, o2, l1, l2
            ms = time_ms(torch, call.launch)
            routed_ms = dict(wrapper_ms=wrapper_ms) if n == 0 else {}
            log(f"  {name} [{call.name}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share {b_ms / ms:.2f}"
                + (f"; the routed wrapper, its host work included, {wrapper_ms:.4f} ms"
                   if routed_ms else ""))
            results.append(dict(case=name, kernel=call.name, err=err, rel_err=rel, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                library_ms=lib_ms, **routed_ms, **plane))
        torch.cuda.empty_cache()
        return
    log(f"  {name}: the backwards read the out and lse of {routed.name}")
    kw = dict(causal=True, scale=scale)

    def kern():
        return flash_attention_bwd(q, k, v, out, lse, dout, qo, kl, **kw)

    def plain():
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, q_offset=qo, kv_len=kl)

    calls = [prepare_flash_bwd(q, k, v, out, lse, dout, qo, kl, **kw)]
    if calls[0].name != "flash_attention_bwd":  # the older backward on the same inputs, by name
        calls.append(prepare_flash_bwd(q, k, v, out, lse, dout, qo, kl, **kw,
                                       kernel="flash_attention_bwd"))
    before = LAUNCHES[calls[0].name]
    kern()
    torch.cuda.synchronize()
    if LAUNCHES[calls[0].name] != before + 1:
        fail(f"{name}: the wrapper did not launch {calls[0].name}, the kernel its rule names")
    want = plain()
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    mha_reference(*leaves, causal=True, q_offset=qo, kv_len=kl).backward(dout.float())
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    do_lib = dout.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True, **sdpa_kw)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qg, kg, vg), do_lib)

    io += dout.numel() * 2 + (q.numel() + k.numel() + v.numel()) * 2  # dout in, grads out
    flops = 10.0 * pairs * H * D  # S again, dP, dV, dQ, dK: five products
    b_ms, b_by = bound_ms(io, flops)
    wrapper_ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, iters=5, warmup=1)
    # SDPA's backward alone: a graph of forward and backward less one of the
    # forward (autograd's backward is captured only with its forward)
    lib_ms = graph_ms(sdpa_fwd_bwd) - graph_ms(sdpa)
    for n, call in enumerate(calls):
        got = []
        for _ in range(2):
            grads = (call.out, *call.aux)
            for g in grads:
                g.fill_(float("nan"))
            b4 = dict(LAUNCHES)
            call.launch()
            torch.cuda.synchronize()
            if {kk: LAUNCHES[kk] - b4[kk] for kk in LAUNCHES if LAUNCHES[kk] != b4[kk]} != \
                    {call.name: 1}:
                fail(f"{name}: a launch of {call.name} was not counted once")
            got.append(tuple(g.clone() for g in grads))
        same = all(bool(torch.equal(a, b)) for a, b in zip(*got))
        err, worst = 0.0, 0.0
        for gname, g, w, w32 in zip(("dq", "dk", "dv"), got[0], want, leaves):
            e, r, row = grad_errors(torch, g, w)
            _e32, r32, _row32 = grad_errors(torch, g, w32.grad)
            finite = bool(torch.isfinite(g.float()).all().item())
            log(f"  {name} [{call.name}] {gname}: max_abs_err {e:.3e}, relative {r:.3e} (limit "
                f"{GRAD_REL_TOL}), worst row / limit {row:.3f}; against fp32 autograd of "
                f"mha_reference: relative {r32:.3e} (limit {GRAD_REL_TOL})")
            if not (r <= GRAD_REL_TOL and row <= 1.0 and r32 <= GRAD_REL_TOL and finite):
                fail(f"{name} {gname}: {call.name} disagrees with its plain backward")
            err, worst = max(err, e), max(worst, r)
        log(f"  {name} [{call.name}]: two launches identical: {same}")
        if not same:
            fail(f"{name}: two launches of {call.name} differ")
        del got
        ms = graph_ms(call.launch)  # one launch of 20 in a CUDA graph
        routed_ms = dict(wrapper_ms=wrapper_ms) if n == 0 else {}
        log(f"  {name} [{call.name}]: kernel {ms:.4f} ms (a launch of 20 in a CUDA graph"
            + (f"; the routed wrapper, its host work included, {wrapper_ms:.4f} ms"
               if routed_ms else "")
            + f"), plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms (graphs: forward and "
            f"backward less forward), bound {b_ms:.4f} ms ({b_by}), share {b_ms / ms:.2f}")
        results.append(dict(case=name, kernel=call.name, err=err, rel_err=worst, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                            **routed_ms, **plane))
    del leaves
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 3: serve
# --------------------------------------------------------------------------

CONTEXTS = [
    "Income: 6,200/month. Savings goal: emergency fund of 15,000.",
    "Recent transactions: groceries 142.10, rent 1,850.00, utilities 96.45. " * 6,
    "Accounts: checking 3,410; savings 8,900; 401k 41,250; credit card balance 1,240. " * 12,
    "Goal: pay off a 9,800 car loan at 6.9% APR within 18 months. " * 20,
    "User profile: 29 years old, salaried, contributes 6% to a 401k with 4% match. " * 4,
    "Spending last month: dining 410, travel 980, subscriptions 64, fuel 188. " * 10,
    "Debts: student loan 22,400 at 5.1%; no other debt. Risk appetite: moderate. " * 16,
    "Question context: considering a Roth IRA versus paying extra on the student loan. " * 8,
]


MESSAGES = [f"Request {i}: what should I do next with my money?" for i in range(8)]
# the resilience drills' streams: new tokens each
DRILL_NEW = 32


class _Counts:
    """What the engine's steps did in a window: prefill chunks
    (``prefill_chunk`` calls: one launch of the Hopper prefill body a
    layer), and the prefill rows and tokens they and the ragged rounds
    carried (a row of the round that reads its token from the device is a
    decode row, not a prefill row)."""

    def __init__(self, engine):
        self.engine = engine
        self.chunks = self.rows = self.tokens = 0
        prefill_chunk, ragged_mixed = engine.prefill_chunk, engine.ragged_mixed

        def counting_prefill_chunk(tokens, slots, start_pos, n_valid):
            self.chunks += 1
            self.rows += sum(1 for n in n_valid if n > 0)
            self.tokens += int(sum(n_valid))
            return prefill_chunk(tokens, slots, start_pos, n_valid)

        def counting_ragged_mixed(tokens, tok_row, row_slot, row_start, row_len,
                                  row_from_device, *rest):
            live = [int(n) for n, d in zip(row_len, row_from_device) if n > 0 and not d]
            self.rows += len(live)
            self.tokens += sum(live)
            return ragged_mixed(tokens, tok_row, row_slot, row_start, row_len,
                                row_from_device, *rest)

        engine.prefill_chunk = counting_prefill_chunk
        engine.ragged_mixed = counting_ragged_mixed

    def reset(self) -> None:
        self.chunks = self.rows = self.tokens = 0

    def close(self) -> None:
        del self.engine.prefill_chunk, self.engine.ragged_mixed


class _DispatchBook:
    """Which requests the engine's steps carried, counted at the engine (not
    from the trace): a prefill chunk carries the slots of its rows with
    tokens, a ragged round the slots of its rows with tokens, a decode step
    its active slots; each is booked to the request in that slot. Rows of a
    prefix registration (no request) are not booked."""

    NAMES = ("prefill_chunk", "ragged_mixed", "decode")

    def __init__(self, engine, sched):
        self.engine, self.counts = engine, {}
        self.saved = {n: (n in vars(engine), getattr(engine, n)) for n in self.NAMES}

        def book(slots):
            live = {h.slot: h for h in list(sched.prefilling) + list(sched.decoding.values())}
            for slot in slots:
                if slot in live:
                    self.counts[live[slot].seq_id] = self.counts.get(live[slot].seq_id, 0) + 1

        prefill_chunk, ragged_mixed, decode = (self.saved[n][1] for n in self.NAMES)

        def booked_prefill_chunk(tokens, slots, start_pos, n_valid):
            book([int(s) for s, n in zip(slots, n_valid) if n > 0])
            return prefill_chunk(tokens, slots, start_pos, n_valid)

        def booked_ragged_mixed(tokens, tok_row, row_slot, row_start, row_len, *rest):
            book([int(s) for s, n in zip(row_slot, row_len) if n > 0])
            return ragged_mixed(tokens, tok_row, row_slot, row_start, row_len, *rest)

        def booked_decode(active, *a, **k):
            book([s for s, on in enumerate(active) if on])
            return decode(active, *a, **k)

        engine.prefill_chunk = booked_prefill_chunk
        engine.ragged_mixed = booked_ragged_mixed
        engine.decode = booked_decode

    def close(self) -> None:
        for name, (had, fn) in self.saved.items():
            if had:
                setattr(self.engine, name, fn)
            else:
                delattr(self.engine, name)


def trace_cost_us(sched, rows: int, n: int = 20000, block: int = 2000) -> tuple[float, float]:
    """Host µs a dispatch pays for tracing: the decode dispatch's row list
    for ``rows`` members built and recorded through the scheduler's own
    ``_trace_dispatch``, as ``_dispatch_decode`` does under
    ``TRACER.enabled``. The ring's events are objects the garbage collector
    walks, so the cost grows with what the ring holds: the mean of the first
    ``block`` calls (the ring nearly empty) and of the last (``n`` events
    in it)."""
    from types import SimpleNamespace

    from finchat_tpu_torch.utils.tracing import TRACER

    members = [(s, SimpleNamespace(trace_id=f"trace-{s}", seq_id=f"seq-{s}"), 0)
               for s in range(rows)]
    TRACER.clear()
    means = []
    for _ in range(n // block):
        t0 = time.perf_counter()
        for _ in range(block):
            if TRACER.enabled:
                sched._trace_dispatch("decode", [[slot, h.trace_id or h.seq_id, "decode"]
                                                 for slot, h, _e in members])
        means.append((time.perf_counter() - t0) / block * 1e6)
    TRACER.clear()
    return means[0], means[-1]


def check_traced_window(plane: str, handles, book: _DispatchBook, sched) -> dict:
    """Turn 1 ran traced: every request's timeline (``TRACER.export``) holds
    its lifecycle marks and the request span, and the dispatch events whose
    rows name its trace id are exactly as many as the steps that carried it
    (``_DispatchBook``). The window is written as one Chrome trace (the
    requests' exports merged) to a temporary file, and tracing's host cost a
    dispatch is measured (``trace_cost_us``)."""
    import tempfile

    from finchat_tpu_torch.utils.tracing import TRACER

    events = TRACER.snapshot()
    merged, per = {}, {}
    for h in handles:
        tid = h.trace_id
        rows = sum(1 for ev in events if ev[2] == "dispatch"
                   and any(r[1] == tid for r in ev[5]["rows"]))
        export = TRACER.export(tid)
        names = {e["name"] for e in export["traceEvents"]}
        per[h.seq_id] = dict(dispatch_rows=rows, booked=book.counts.get(h.seq_id, 0),
                             events=len(export["traceEvents"]))
        if not {"admitted", "prefill_done", "first_token", "done", "request"} <= names:
            fail(f"traced serve ({plane}): {tid}'s timeline lacks marks: {sorted(names)}")
        if rows != per[h.seq_id]["booked"] or rows == 0:
            fail(f"traced serve ({plane}): {tid} is in the rows of {rows} dispatches, the "
                 f"steps carried it {per[h.seq_id]['booked']} times")
        for e in export["traceEvents"]:
            merged[(e["ts"], e["name"], e["tid"])] = e
    path = Path(tempfile.mkdtemp(prefix="finchat-trace-")) / f"serve-{plane}.json"
    path.write_text(json.dumps({"traceEvents": sorted(merged.values(), key=lambda e: e["ts"]),
                                "displayTimeUnit": "ms"}))
    n_dispatch = sum(1 for ev in events if ev[2] == "dispatch")
    cost = {rows: trace_cost_us(sched, rows) for rows in (8, 64)}
    log(f"  traced serve ({plane}): {len(events)} events, {n_dispatch} dispatches; each "
        f"request in as many dispatch rows as steps carried it "
        f"({[v['dispatch_rows'] for v in per.values()]}); the window as a Chrome trace, "
        f"{path.stat().st_size} bytes; tracing's host cost a decode dispatch: "
        + "; ".join(f"{rows} rows {a:.2f} µs (the ring nearly empty), {b:.2f} µs (20,000 "
                    "events in it)" for rows, (a, b) in cost.items()))
    path.unlink()
    path.parent.rmdir()
    return dict(events=len(events), dispatches=n_dispatch, requests=per,
                host_us_per_dispatch={str(k): list(v) for k, v in cost.items()})


def _metric_delta(metrics, before: dict, name: str) -> float:
    return metrics.snapshot().get(name, 0.0) - before.get(name, 0.0)


def _seconds(metrics, before: dict, name: str) -> dict:
    """A histogram's observations in a window: count, total and mean s."""
    n = _metric_delta(metrics, before, f"{name}_count")
    total = _metric_delta(metrics, before, f"{name}_sum")
    return dict(n=int(n), total_s=total, mean_s=total / n if n else None)


def check_window(plane: str, what: str, spec: dict, config, launches: dict, counts: _Counts,
                 decode_steps: float, rounds: float) -> None:
    """The launch rules every serving window holds: the Hopper prefill body
    of the cache takes every prefill chunk, one launch a layer, and the
    older paged body none; the KV-row writer of the cache takes every cache
    write, one launch a layer of every decode step, prefill chunk and ragged
    round; no kernel the routing keeps off this path is launched."""
    older = "paged_attention_q8" if spec["kv_quant"] else "paged_attention"
    want_chunks = counts.chunks * config.n_layers
    log(f"  {what}: prefill chunks {counts.chunks}: {launches[older + '_sm90']} launches of the "
        f"Hopper prefill body (want {want_chunks}), {launches[older]} of the older paged body")
    if launches[older] != 0:
        fail(f"serve {plane} ({what}): {launches[older]} calls reached the older paged body")
    if launches[older + "_sm90"] != want_chunks:
        fail(f"serve {plane} ({what}): the Hopper prefill body took "
             f"{launches[older + '_sm90']} calls, not one a layer of each of {counts.chunks} "
             "prefill chunks")
    stray = {k: launches[k] for k in spec.get("never", ()) if launches[k]}
    if stray:
        fail(f"serve {plane} ({what}): calls reached kernels the routing keeps off this path: "
             f"{stray}")
    writer, older_append = (("kv_append_q8_sm90", "kv_append_q8") if spec["kv_quant"]
                            else ("kv_append_sm90", "kv_append"))
    want_writes = int(config.n_layers * (decode_steps + counts.chunks + rounds))
    log(f"  {what}: KV writes: {launches[writer]} launches of {writer} (want {want_writes} = "
        f"{config.n_layers} x ({decode_steps:.0f} decode steps + {counts.chunks} chunks + "
        f"{rounds:.0f} rounds)), {launches[older_append]} of the older append")
    if launches[writer] != want_writes:
        fail(f"serve {plane} ({what}): the KV-row writer took {launches[writer]} layer writes, "
             f"not one a layer of every step ({want_writes})")


def check_prefill_rows(plane: str, what: str, handles, counts: _Counts, chunk: int,
                       start_of) -> None:
    """Every request prefilled its prompt from where its cached KV ends
    (``start_of(handle)``), in chunks of ``chunk``: the rows and tokens the
    engine's steps carried equal what the prompt lengths need."""
    want_rows = sum(-(-(len(h.prompt_ids) - start_of(h)) // chunk) for h in handles)
    want_tokens = sum(len(h.prompt_ids) - start_of(h) for h in handles)
    cold_rows = sum(-(-len(h.prompt_ids) // chunk) for h in handles)
    log(f"  {what}: prefill rows {counts.rows} carrying {counts.tokens} tokens (want "
        f"{want_rows} rows, {want_tokens} tokens; {cold_rows} rows without the caches)")
    if (counts.rows, counts.tokens) != (want_rows, want_tokens):
        fail(f"serve {plane} ({what}): the steps prefilled {counts.rows} rows / {counts.tokens} "
             f"tokens, the prompts need {want_rows} / {want_tokens}")


async def _stream_ids(sched, seq_id: str, ids: list[int], sampling, conversation_id: str):
    handle = await sched.submit(seq_id, ids, sampling, conversation_id=conversation_id)
    while True:
        event = await handle.events.get()
        if event["type"] == "done":
            return handle
        if event["type"] == "error":
            fail(f"{seq_id}: {event['message']}")


def _head_equal(torch, before: tuple, after: tuple) -> bool:
    return all((a is None and b is None) or torch.equal(a, b) for a, b in zip(before, after))


def pool_bytes(engine) -> int:
    """Device bytes of the engine's KV pool (pages and scale planes)."""
    s = engine.state
    return sum(t.numel() * t.element_size()
               for t in (s.k_pages, s.v_pages, s.k_scales, s.v_scales) if t is not None)


def pages_zero_past_trash(torch, engine) -> bool:
    """Whether every page but the trash page 0 is all zero, K, V and the
    scale planes: one min/max reduction a tensor over its pages 1.., one
    amax over their results, one host read."""
    s = engine.state
    ends = [torch.stack(torch.aminmax(t[:, 1:])).float().abs()
            for t in (s.k_pages, s.v_pages, s.k_scales, s.v_scales) if t is not None]
    return float(torch.cat(ends).amax().item()) == 0.0


def run_warmup(torch, plane: str, engine, weight_gb: float) -> dict:
    """``engine.warmup()`` as the app runs it at start: its seconds, its
    variant count, its launches by kernel (counts set to 0 just before), its
    peak memory, and the pool checked untouched past the trash page."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seconds = engine.warmup()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    zero = pages_zero_past_trash(torch, engine)
    log(f"  warmup ({plane}): {engine.compiled_variants} step variants in {seconds:.2f} s; "
        f"peak {peak_gb:.2f} GB (weights {weight_gb:.2f}, pool {pool_bytes(engine) / 1e9:.2f}); "
        f"launches {launches}; pages 1.. all zero after it: {zero}")
    if not zero:
        fail(f"warmup ({plane}) wrote a page other than the trash page")
    return dict(seconds=seconds, variants=engine.compiled_variants, launches=launches,
                peak_gb=peak_gb)


async def serve(torch, dev, plane: str, n_requests: int, max_new: int, profile: bool,
                later_turns: bool, drills: tuple = (), agent: tuple = (),
                retrieval: dict | None = None) -> dict:
    """Serve ``n_requests`` greedy requests through ``LLMService`` on one
    serving plane (``PLANES``) at ``EngineConfig``'s defaults, the prefix
    and session caches, preemption and the breaker on: the engine warmed up
    first, as the app does, then the system head registered, half the
    requests at once, the rest once a first token streams, each its own
    conversation. Launch counts are set to 0 just before the head's
    registration and read just after the serve. With ``later_turns``, then
    turn 2 of four conversations on the same scheduler and turn 3 of two on
    a fresh one, each a window of its own. ``drills`` names the resilience
    drills to run on the same weights afterwards: "breaker" on this engine,
    "preemption" (with the shutdown drain) on a second, smaller one.
    Turn 1 is traced: every request carries a ``trace_id``, and the rows
    of the dispatch events must name each request exactly as often as the
    engine's steps carried its slot (``_DispatchBook``). ``agent`` names
    the agent planes to run on this engine after the later turns:
    "constrained", and "partial" with it (``agent_planes``)."""
    import shutil
    import tempfile

    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.engine.generator import EngineGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.llama import PRESETS, init_params, n_params
    from finchat_tpu_torch.models.quant import init_quantized_params
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat_head
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.simple import LLMService
    from finchat_tpu_torch.utils.config import EngineConfig
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    spec = PLANES[plane]
    config = PRESETS["llama3-8b"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    gc.collect()  # the previous plane's tree and cache are gone before this one's
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if spec["quant"]:
        params = init_quantized_params(config, gen, dev, mode=spec["quant"],
                                       group_size=spec["group"])
    else:
        params = init_params(config, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = (torch.cuda.memory_allocated() - base) / 1e9
    log(f"  llama3-8b: {config.n_layers} layers, {n_params(config) / 1e9:.2f} B params, "
        f"weights {weight_gb:.2f} GB on the card ({plane}), random init {init_s:.1f} s, "
        f"init peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB above the "
        f"{base / 1e9:.2f} GB held before")
    disk_dir = tempfile.mkdtemp(prefix="finchat-sessions-")
    try:
        ecfg = EngineConfig(kv_quant=spec["kv_quant"], session_cache_disk_path=disk_dir)
        fb0 = METRICS.get("finchat_quantmatmul_fallbacks_total")
        engine = InferenceEngine(config, params, ecfg, device=dev, quant=spec["quant"],
                                 quant_group=spec["group"])
        warm = run_warmup(torch, plane, engine, weight_gb)
        torch.cuda.reset_peak_memory_stats()
        counts = _Counts(engine)
        tok = ByteTokenizer()
        sched = ContinuousBatchingScheduler(engine, tok.eos_id)
        book = _DispatchBook(engine, sched)
        handles = []
        submit = sched.submit

        async def recording_submit(*a, **k):
            h = await submit(*a, **k)
            handles.append(h)
            return h

        sched.submit = recording_submit
        system_prompt = (REPO / "prompts" / "system_prompt.txt").read_text()
        # the head as the app registers it: BOS added, the last token dropped
        head_ids = tok.encode(render_chat_head(system_prompt), add_bos=True)[:-1]
        svc = LLMService(EngineGenerator(sched, tok), system_prompt,
                         SamplingParams(temperature=0.0, max_new_tokens=max_new))
        m0 = METRICS.snapshot()
        reset_launches()
        shared = sched.register_prefix(head_ids)
        reg_chunks = counts.chunks
        head_pages = list(sched._prefixes[0].pages) if sched._prefixes else []
        log(f"  prefix cache: the system head ({len(head_ids)} tokens) registered as {shared} "
            f"shared tokens, {len(head_pages)} pages, in {reg_chunks} prefill chunks")
        if shared != (len(head_ids) // engine.page_size) * engine.page_size or not shared:
            fail(f"serve {plane}: the system head registered {shared} shared tokens")
        head0 = engine.offload_pages(head_pages)
        counts.reset()
        await sched.start()

        async def one(i: int) -> str:
            text = []
            async for chunk in svc.process_message(MESSAGES[i], context=CONTEXTS[i],
                                                   conversation_id=f"conv-{i}",
                                                   trace_id=f"trace-{plane}-{i}"):
                text.append(chunk)
            return "".join(text)

        TRACER.clear()
        t_start = time.perf_counter()
        first = n_requests // 2
        wave1 = [asyncio.create_task(one(i)) for i in range(first)]
        while not any(h.generated > 0 for h in handles):
            await asyncio.sleep(0.005)
        wave2 = [asyncio.create_task(one(i)) for i in range(first, n_requests)]
        await asyncio.gather(*wave1, *wave2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        await sched.stop()
        sched.submit = submit  # break the wrapper's cycle so the tree can go
        launches = dict(LAUNCHES)
        book.close()
        tracing = check_traced_window(plane, handles, book, sched)
        prompt_lens = [len(h.prompt_ids) for h in handles]
        log(f"  served {len(handles)} requests in {wall:.2f} s; prompt tokens {prompt_lens}")
        log(f"  launches during serve: {launches}")
        if len(handles) != n_requests or not all(h.finished and h.generated > 0 for h in handles):
            fail(f"serve {plane}: not every request completed with tokens")
        if not all(h.generated == max_new or h.history[-1] == tok.eos_id for h in handles):
            fail(f"serve {plane}: a request ended before max_new_tokens without EOS")
        missing = [k for k in spec["kernels"] if launches[k] == 0]
        if missing:
            fail(f"serve {plane}: kernels not launched on the main path: {missing}")
        if sched.quant_label != plane.replace("g128", ""):
            fail(f"serve {plane}: the scheduler reports quant label {sched.quant_label}")
        hits = _metric_delta(METRICS, m0, "finchat_prefix_hits_total")
        saved = _metric_delta(METRICS, m0, "finchat_prefix_tokens_saved_total")
        log(f"  prefix cache: {hits:.0f}/{n_requests} hits, {saved:.0f} prefill tokens saved "
            f"(want {n_requests} x {shared})")
        if hits != n_requests or saved != n_requests * shared or any(
                h.shared_len != shared for h in handles):
            fail(f"serve {plane}: {hits:.0f} prefix hits saving {saved:.0f} tokens, not "
                 f"{n_requests} saving {n_requests * shared}")
        check_prefill_rows(plane, "turn 1", handles, counts, ecfg.prefill_chunk,
                           lambda h: h.shared_len)
        ttfts = sorted(h.first_token_at - h.submitted_at for h in handles)
        ttft_p50 = statistics.median(ttfts)
        decode_tokens = sum(h.generated - 1 for h in handles)
        t_first = min(h.first_token_at for h in handles)
        t_last = max(h.last_token_at for h in handles)
        agg_tps = decode_tokens / max(t_last - t_first, 1e-9)
        per_stream = statistics.median(
            (h.generated - 1) / max(h.last_token_at - h.first_token_at, 1e-9) for h in handles)
        mixed = _metric_delta(METRICS, m0, "finchat_mixed_dispatches_total")
        coexist = _metric_delta(METRICS, m0, "finchat_coexist_iterations_total")
        log(f"  ragged rounds {mixed:.0f}, coexist iterations {coexist:.0f}; gauges: "
            f"weight bits {METRICS.get('finchat_quant_weight_bits'):.0f}, "
            f"KV bits {METRICS.get('finchat_quant_kv_bits'):.0f}")
        if mixed < 1:
            fail(f"serve {plane}: no packed ragged round ran (prefill never coexisted with "
                 "decode)")
        decode_steps = _metric_delta(METRICS, m0, "finchat_decode_dispatches_total")
        counts.chunks += reg_chunks  # the registration's chunks ran in this window too
        check_window(plane, "turn 1", spec, config, launches, counts, decode_steps, mixed)
        # a dense tree: every quantized matmul goes to a kernel, none falls
        # back (moe_phase's expert einsums do)
        fb = METRICS.get("finchat_quantmatmul_fallbacks_total") - fb0
        log(f"  finchat_quantmatmul_fallbacks_total +{fb:.0f} since the engine was built")
        if fb:
            fail(f"serve {plane}: {fb:.0f} quantized matmuls fell back from the kernels")
        offload1 = _seconds(METRICS, m0, "finchat_session_offload_seconds")
        log(f"  session cache: {len(sched.session_cache)} entries in RAM "
            f"({sched.session_cache.resident_bytes / 2**20:.1f} MiB of "
            f"{ecfg.session_cache_bytes / 2**20:.0f}), offloads {offload1['n']} taking "
            f"{offload1['total_s']:.3f} s, "
            f"{_metric_delta(METRICS, m0, 'finchat_session_cache_offloaded_pages_total'):.0f} "
            "pages")
        if sched.allocator.used_count != len(head_pages):
            fail(f"serve {plane}: {sched.allocator.used_count} KV pages allocated after the serve, "
                 f"not the head's {len(head_pages)}")
        turn1 = dict(ttft_p50_s=ttft_p50, ttft_s=ttfts, prefix_hits=hits, tokens_saved=saved,
                     prefill_rows=counts.rows, offload=offload1)
        checks = [teacher_forced_check(torch, params, config, h, spec["kv_quant"])
                  for h in handles]
        turns = {}
        if later_turns:
            turns["turn2"] = await later_turn(
                torch, plane, spec, config, engine, sched, counts, handles[:4], 2, shared,
                METRICS, reset_launches, LAUNCHES, tok, params, SamplingParams, from_disk=False)
        if not _head_equal(torch, head0, engine.offload_pages(head_pages)):
            fail(f"serve {plane}: the shared head's pages changed during the serve")
        log(f"  the head's {len(head_pages)} pages are bit-identical after the serve")
        if later_turns:
            spilled = sched.spill_sessions()
            sched.retire_prefixes()
            log(f"  spilled {spilled} session entries; after retire_prefixes "
                f"{sched.allocator.used_count} pages allocated")
            if sched.allocator.used_count != 0:
                fail(f"serve {plane}: {sched.allocator.used_count} KV pages leaked")
            sched.session_cache.disk.close()
            # a fresh scheduler on the same engine and directory: a restart
            fresh = ContinuousBatchingScheduler(engine, tok.eos_id)
            turns["turn3"] = await later_turn(
                torch, plane, spec, config, engine, fresh, counts,
                turns["turn2"].pop("handles")[:2], 3, shared, METRICS, reset_launches, LAUNCHES, tok, params, SamplingParams,
                from_disk=True, head_ids=head_ids)
            turns["turn3"].pop("handles")
            sched = fresh
        sched.retire_prefixes()
        if sched.allocator.used_count != 0:
            fail(f"serve {plane}: {sched.allocator.used_count} KV pages still allocated")
        if sched.session_cache.disk is not None:
            sched.session_cache.disk.close()
        counts.close()
        agent_stats = (await agent_planes(torch, plane, spec, config, engine, params, head_ids,
                                          system_prompt, shared, partial="partial" in agent)
                       if "constrained" in agent else None)
        if "turns" in agent:
            agent_stats["turns"] = await agent_turns(
                torch, plane, spec, config, engine, params, system_prompt,
                pairs=2 if "overlap" in agent else 1, overlap_runs="overlap" in agent,
                retrieval=retrieval)
        steps = (profile_steps(torch, engine, context=max(prompt_lens), active=len(handles))
                 if profile else None)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        drill = {}
        if "breaker" in drills:
            drill["breaker"] = await breaker_drill(torch, plane, spec, config, engine, params,
                                                   head_ids, system_prompt, shared)
        del engine, sched, svc, recording_submit, submit, counts
        gc.collect()
        torch.cuda.empty_cache()
        if "preemption" in drills:
            drill["preemption"] = await preemption_drill(torch, dev, plane, spec, config, params,
                                                         head_ids, system_prompt, shared,
                                                         disk_dir)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(disk_dir, ignore_errors=True)
    return dict(plane=plane, ttft_p50_s=ttft_p50, ttft_s=ttfts, decode_tokens_per_s=agg_tps,
                decode_tokens_per_s_per_stream=per_stream, wall_s=wall,
                prompt_tokens=prompt_lens, launches=launches, ragged_rounds=mixed,
                weight_gb=weight_gb, peak_gb=peak_gb, teacher_forced=checks, steps=steps,
                shared_tokens=shared, turn1=turn1, warmup=warm, drills=drill, tracing=tracing,
                agent=agent_stats, **turns)


async def later_turn(torch, plane, spec, config, engine, sched, counts, prev, turn: int,
                     shared: int, metrics, reset_launches, launches_now, tok, params,
                     sampling_cls, from_disk: bool, head_ids=None) -> dict:
    """Turn ``turn`` of the conversations of ``prev`` (their handles of the
    turn before): each prompt is that turn's history plus a new message,
    16 new tokens, all submitted at once. Every conversation must resume
    from its own cached pages — from RAM or the disk tier, and only from
    disk with ``from_disk`` (a fresh scheduler, the head registered anew
    from ``head_ids``) — and prefill only what follows them."""
    m0 = metrics.snapshot()
    reset_launches()
    counts.reset()
    if head_ids is not None:
        if sched.register_prefix(head_ids) != shared:
            fail(f"serve {plane}: turn {turn}: the head did not register again")
    reg_chunks = counts.chunks
    counts.reset()
    await sched.start()
    sampling = sampling_cls(temperature=0.0, max_new_tokens=16)
    t_start = time.perf_counter()
    handles = await asyncio.gather(*[
        _stream_ids(sched, f"turn{turn}-{i}",
                    h.history + tok.encode(f" Follow-up {turn}.{i}: and after that?",
                                           add_bos=False),
                    sampling, h.conversation_id)
        for i, h in enumerate(prev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    await sched.stop()
    launches = dict(launches_now)
    n = len(prev)
    hits = _metric_delta(metrics, m0, "finchat_session_cache_hits_total")
    disk = _metric_delta(metrics, m0, "finchat_durability_disk_restores_total")
    restored = _metric_delta(metrics, m0, "finchat_session_cache_restored_tokens_total")
    restore = _seconds(metrics, m0, "finchat_session_restore_seconds")
    offload = _seconds(metrics, m0, "finchat_session_offload_seconds")
    disk_s = _seconds(metrics, m0, "finchat_durability_restore_seconds")
    prompt_lens = [len(h.prompt_ids) for h in handles]
    log(f"  turn {turn}: {n} conversations in {wall:.2f} s; prompt tokens {prompt_lens}, "
        f"resumed {[h.resumed_len for h in handles]}")
    log(f"  turn {turn}: session hits {hits:.0f}/{n} ({disk:.0f} from disk), restored tokens "
        f"{restored:.0f}; restores {restore['n']} taking {restore['total_s']:.3f} s, disk "
        f"reads {disk_s['n']} taking {disk_s['total_s']:.3f} s, offloads {offload['n']} "
        f"taking {offload['total_s']:.3f} s")
    if hits != n or any(h.resumed_len <= shared for h in handles):
        fail(f"serve {plane}: turn {turn}: {hits:.0f}/{n} session hits")
    if from_disk and disk != n:
        fail(f"serve {plane}: turn {turn}: {disk:.0f}/{n} conversations restored from disk")
    if not all(h.finished and h.generated > 0 for h in handles):
        fail(f"serve {plane}: turn {turn}: not every request completed with tokens")
    check_prefill_rows(plane, f"turn {turn}", handles, counts, engine.engine_cfg.prefill_chunk,
                       lambda h: h.resumed_len)
    decode_steps = _metric_delta(metrics, m0, "finchat_decode_dispatches_total")
    rounds = _metric_delta(metrics, m0, "finchat_mixed_dispatches_total")
    counts.chunks += reg_chunks
    check_window(plane, f"turn {turn}", spec, config, launches, counts, decode_steps, rounds)
    checks = [teacher_forced_check(torch, params, config, h, spec["kv_quant"]) for h in handles]
    ttfts = sorted(h.first_token_at - h.submitted_at for h in handles)
    return dict(handles=handles, ttft_p50_s=statistics.median(ttfts), ttft_s=ttfts,
                session_hits=hits, disk_restores=disk, restored_tokens=restored,
                restore=restore, disk_read=disk_s, offload=offload, wall_s=wall,
                prompt_tokens=prompt_lens, teacher_forced=checks)


def _as_served(h, prompt_ids: list[int]):
    """A handle seen with the prompt it was submitted with: a replay's
    ``prompt_ids`` hold its history at the preemption, and the
    teacher-forced check must cover every token it streamed."""
    from types import SimpleNamespace

    return SimpleNamespace(seq_id=h.seq_id, prompt_ids=prompt_ids, history=h.history,
                           shared_len=h.shared_len, resumed_len=h.resumed_len)


def _stream_ended(plane: str, what: str, h, eos_id: int) -> None:
    if not (h.finished and (h.generated == h.sampling.max_new_tokens
                            or h.history[-1] == eos_id)):
        fail(f"{what} ({plane}): {h.seq_id} ended after {h.generated} of "
             f"{h.sampling.max_new_tokens} tokens without EOS")


def check_trip_launches(plane: str, spec: dict, config, launches: dict, counts: _Counts,
                        decode_steps: float, rounds: float) -> None:
    """After the trip, every kernel of the plane launched (the Hopper bodies
    over the rebuilt pool), the serve's launch rules held, and no older body
    launched."""
    missing = [k for k in spec["kernels"] if launches[k] == 0]
    if missing:
        fail(f"breaker drill ({plane}): kernels not launched after the trip: {missing}")
    check_window(plane, "after the trip", spec, config, launches, counts, decode_steps, rounds)


async def breaker_drill(torch, plane: str, spec: dict, config, engine, params, head_ids,
                        system_prompt: str, shared: int) -> dict:
    """The circuit breaker at full width on the serve's engine and weights,
    at ``EngineConfig``'s defaults: four requests of the serve's shape
    stream over the registered head; once each has 2 tokens,
    ``scheduler.decode`` fails ``breaker_threshold`` times in a row. The
    trip rebuilds the pool on the card, an ``on_rebuild`` callback
    re-registers the head (``register_prefix_async``), and the streams
    replay: each must complete teacher-forced, the rebuild counter rise by
    one and the breaker close. Launch counts are set to 0 in the callback:
    every kernel of the plane must launch after the trip, and no older body.
    Peak memory across the rebuild must stay under the held memory plus one
    pool. A request after the drill must hit the re-registered head. The
    flight recorder writes to a temporary directory during the drill: the
    trip's dump must load through ``load_flight_dump`` (its checksum
    verified) and hold the trip and the tripped rounds' dispatches."""
    import shutil
    import tempfile

    from finchat_tpu_torch.engine.generator import EngineGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.simple import LLMService
    from finchat_tpu_torch.utils import faults
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER, load_flight_dump

    log(f"  breaker drill ({plane}): 4 requests over the head, {DRILL_NEW} new tokens each")
    flight_dir = tempfile.mkdtemp(prefix="finchat-flight-")
    tok = ByteTokenizer()
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    if sched.breaker_threshold < 1 or not sched.preemption_enabled:
        fail(f"breaker drill ({plane}): EngineConfig's defaults lost the breaker or preemption")
    if sched.register_prefix(head_ids) != shared:
        fail(f"breaker drill ({plane}): the head did not register")
    counts = _Counts(engine)
    handles, prompts = [], {}
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        prompts[h.seq_id] = list(h.prompt_ids)
        return h

    sched.submit = recording_submit
    deliveries: dict[str, list[float]] = {}
    deliver = sched._deliver

    def timed_deliver(h, token_id):
        deliveries.setdefault(h.seq_id, []).append(time.perf_counter())
        deliver(h, token_id)

    sched._deliver = timed_deliver
    trip: dict = {}

    def on_rebuild():
        # the window after the trip starts here: nothing has run on the new pool
        trip.update(t=sched._breaker_tripped_at, rebuilt=time.perf_counter(),
                    m=METRICS.snapshot(),
                    register=asyncio.ensure_future(sched.register_prefix_async(head_ids)))
        reset_launches()
        counts.reset()

    sched.on_rebuild.append(on_rebuild)
    svc = LLMService(EngineGenerator(sched, tok), system_prompt,
                     SamplingParams(temperature=0.0, max_new_tokens=DRILL_NEW))

    async def one(i: int) -> None:
        async for _chunk in svc.process_message(MESSAGES[i], context=CONTEXTS[i],
                                                conversation_id=f"drill-{plane}-{i}"):
            pass

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    pool = pool_bytes(engine)
    torch.cuda.reset_peak_memory_stats()
    m0 = METRICS.snapshot()
    TRACER.configure(flight_dir=flight_dir)
    await sched.start()
    try:
        tasks = [asyncio.create_task(one(i)) for i in range(4)]
        while len(handles) < 4 or not all(h.generated >= 2 or h.finished for h in handles):
            await asyncio.sleep(0.005)
        faults.arm("scheduler.decode", faults.n_shot(
            sched.breaker_threshold, RuntimeError("drill: wedged decode dispatch")))
        try:
            await asyncio.gather(*tasks)
        finally:
            faults.disarm("scheduler.decode")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if "register" not in trip:
            fail(f"breaker drill ({plane}): the breaker never rebuilt the engine")
        re_registered = await trip["register"]
        if re_registered != shared:
            fail(f"breaker drill ({plane}): the head re-registered {re_registered} tokens")
        hits0 = METRICS.get("finchat_prefix_hits_total")
        await one(4)
        after = handles[4]
        hit = METRICS.get("finchat_prefix_hits_total") - hits0
    finally:
        faults.disarm_all()
        await sched.stop()
        TRACER.configure(flight_dir="")
        TRACER.flush_dumps()  # the dump threads have written before the files are read
    sched.submit = submit
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    dumps = sorted(Path(flight_dir).glob("flight-*-breaker_trip.json"))
    if len(dumps) != 1:
        fail(f"breaker drill ({plane}): {len(dumps)} breaker_trip flight dumps")
    record = load_flight_dump(str(dumps[0]))
    box = record["trace"]["traceEvents"]
    box_dispatches = sum(1 for e in box if e["name"] == "dispatch")
    dump_bytes = dumps[0].stat().st_size
    log(f"  breaker drill ({plane}): the flight dump {dumps[0].name} ({dump_bytes} "
        f"bytes) loads with its checksum: {len(box)} events, {box_dispatches} dispatches, "
        f"anomaly args {record['anomaly_args']}")
    if record["reason"] != "breaker_trip" or not box_dispatches or not any(
            e["name"] == "breaker_trip" for e in box):
        fail(f"breaker drill ({plane}): the flight dump lacks the trip or its dispatches")
    shutil.rmtree(flight_dir, ignore_errors=True)
    rebuilds = _metric_delta(METRICS, m0, "finchat_engine_rebuilds_total")
    failures = _metric_delta(METRICS, m0, "finchat_dispatch_failures_total")
    preemptions = _metric_delta(METRICS, m0, "finchat_preemptions_total")
    state = METRICS.get("finchat_breaker_state")
    rebuild_s = _seconds(METRICS, m0, "finchat_engine_rebuild_seconds")
    recovery_s = _seconds(METRICS, m0, "finchat_breaker_recovery_seconds")
    # a replay's first token after the trip (None: the stream had ended)
    replay_ttft = [next((t - trip["t"] for t in deliveries[h.seq_id] if t > trip["rebuilt"]),
                        None) for h in handles[:4]]
    log(f"  breaker drill ({plane}): {failures:.0f} failed rounds, {preemptions:.0f} "
        f"preemptions, {rebuilds:.0f} rebuild; rebuild {rebuild_s['total_s']:.4f} s, recovery "
        f"{recovery_s['total_s']:.3f} s; the replays' first token "
        f"{[t if t is None else round(t, 3) for t in replay_ttft]} s after the trip; "
        f"breaker state {state:.0f}")
    log(f"  breaker drill ({plane}): peak {(peak - held) / 1e9:.2f} GB above the "
        f"{held / 1e9:.2f} GB held (one pool is {pool / 1e9:.2f} GB); the request after the "
        f"drill: {hit:.0f} prefix hit, {after.shared_len} shared tokens")
    log(f"  breaker drill ({plane}): launches after the trip: "
        f"{ {k: v for k, v in launches.items() if v} }")
    if rebuilds != 1 or state != 0:
        fail(f"breaker drill ({plane}): {rebuilds:.0f} rebuilds, breaker state {state:.0f}")
    if peak - held >= pool:
        fail(f"breaker drill ({plane}): peak {(peak - held) / 1e9:.2f} GB above the held memory "
             f"reaches a second pool ({pool / 1e9:.2f} GB)")
    if hit != 1 or after.shared_len != shared:
        fail(f"breaker drill ({plane}): the request after the drill missed the head")
    for h in handles:
        _stream_ended(plane, "breaker drill", h, tok.eos_id)
    decode_steps = _metric_delta(METRICS, trip["m"], "finchat_decode_dispatches_total")
    rounds = _metric_delta(METRICS, trip["m"], "finchat_mixed_dispatches_total")
    check_trip_launches(plane, spec, config, launches, counts, decode_steps, rounds)
    counts.close()
    if sched.session_cache.disk is not None:
        sched.session_cache.disk.close()
    checks = [teacher_forced_check(torch, params, config, _as_served(h, prompts[h.seq_id]),
                                   spec["kv_quant"]) for h in handles]
    sched.retire_prefixes()
    return dict(failed_rounds=failures, preemptions=preemptions, rebuilds=rebuilds,
                rebuild_s=rebuild_s, recovery_s=recovery_s, replay_ttft_s=replay_ttft,
                flight_dump=dict(events=len(box), dispatches=box_dispatches,
                                 bytes=dump_bytes),
                peak_above_held_gb=(peak - held) / 1e9, pool_gb=pool / 1e9,
                launches_after_trip={k: v for k, v in launches.items() if v},
                teacher_forced=checks)


async def _tokens_then(handle) -> dict:
    """Consume a handle's events to its terminal one, which it returns."""
    while True:
        event = await handle.events.get()
        if event["type"] != "token":
            return event


async def preemption_drill(torch, dev, plane: str, spec: dict, config, params, head_ids,
                           system_prompt: str, shared: int, disk_dir: str) -> dict:
    """Page-pressure preemption at full width on the serve's weights: a
    second engine whose pool holds the head's pages and two requests' own
    pages but not three. Two requests without a deadline stream; a third,
    with a deadline 60 s out, must preempt one of them; all three complete
    teacher-forced with exactly ``DRILL_NEW`` tokens or EOS. Then two more
    requests stream and ``shutdown_drain`` runs once each has a token: each
    ends with the ``shutting_down`` error, its history offloaded to the
    session tier, and no page is left but the head's."""
    import os

    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.engine.kv_cache import pages_needed
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat
    from finchat_tpu_torch.utils.config import EngineConfig
    from finchat_tpu_torch.utils.metrics import METRICS

    tok = ByteTokenizer()
    page = EngineConfig().page_size
    prompts = [tok.encode(render_chat(system_prompt, CONTEXTS[i], [], MESSAGES[i]), add_bos=True)
               for i in range(3)]
    own = [pages_needed(len(p) + DRILL_NEW, page) - shared // page for p in prompts]
    num_pages = 1 + shared // page + sum(own) - 1  # two requests fit, three do not
    ecfg = EngineConfig(kv_quant=spec["kv_quant"], num_pages=num_pages,
                        session_cache_disk_path=os.path.join(disk_dir, "drill"))
    engine = InferenceEngine(config, params, ecfg, device=dev, quant=spec["quant"],
                             quant_group=spec["group"])
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    if sched.register_prefix(head_ids) != shared:
        fail(f"preemption drill ({plane}): the head did not register")
    log(f"  preemption drill ({plane}): a pool of {num_pages} pages (the head's "
        f"{shared // page}, own pages a request {own}); two requests, then one with a "
        "deadline 60 s out")
    greedy = SamplingParams(temperature=0.0, max_new_tokens=DRILL_NEW)
    m0 = METRICS.snapshot()
    await sched.start()
    try:
        first = [await sched.submit(f"pressure-{i}", prompts[i], greedy) for i in range(2)]
        ends = [asyncio.create_task(_tokens_then(h)) for h in first]
        while not all(h.generated >= 1 or h.finished for h in first):
            await asyncio.sleep(0.005)
        urgent = await sched.submit("pressure-urgent", prompts[2], greedy,
                                    deadline=time.perf_counter() + 60.0)
        ends.append(asyncio.create_task(_tokens_then(urgent)))
        events = await asyncio.gather(*ends)
        handles = first + [urgent]
        preemptions = _metric_delta(METRICS, m0, "finchat_preemptions_total")
        log(f"  preemption drill ({plane}): {preemptions:.0f} preemptions; preempted "
            f"{[h.preempted for h in handles]}; tokens {[h.generated for h in handles]}; "
            f"ends {[e.get('reason', e.get('message')) for e in events]}")
        if preemptions < 1:
            fail(f"preemption drill ({plane}): page pressure preempted nothing")
        if any(e["type"] != "done" for e in events):
            fail(f"preemption drill ({plane}): a stream failed: {events}")
        for h in handles:
            _stream_ended(plane, "preemption drill", h, tok.eos_id)
        # the shutdown drain: two more streams, drained once each has a token
        drain = [await sched.submit(f"drain-{i}", prompts[i], greedy,
                                    conversation_id=f"drain-{plane}-{i}") for i in range(2)]
        while not all(h.generated >= 1 for h in drain):
            await asyncio.sleep(0.005)
    finally:
        await sched.shutdown_drain()
    last = [await _tokens_then(h) for h in drain]
    disk = sched.session_cache.disk
    offloaded = [h.conversation_id in disk for h in drain]
    used = sched.allocator.used_count
    log(f"  shutdown drain ({plane}): errors {[e.get('code') for e in last]} after "
        f"{[h.generated for h in drain]} tokens; offloaded to the disk tier {offloaded}; "
        f"{used} pages left (the head's {shared // page})")
    want = {"type": "error", "message": "server shutting down; retry with backoff",
            "code": "shutting_down", "retryable": True}
    if any(e != want for e in last):
        fail(f"shutdown drain ({plane}): the stragglers ended with {last}")
    if not all(offloaded):
        fail(f"shutdown drain ({plane}): a straggler's history did not reach the session tier")
    if used != shared // page or sched.decoding or sched.prefilling or sched.pending:
        fail(f"shutdown drain ({plane}): {used} pages left, not the head's {shared // page}")
    disk.close()
    checks = [teacher_forced_check(torch, params, config, _as_served(h, prompts[i]),
                                   spec["kv_quant"]) for i, h in enumerate(handles)]
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()
    return dict(num_pages=num_pages, own_pages=own, preemptions=preemptions,
                preempted=[h.preempted for h in handles], teacher_forced=checks,
                drained_tokens=[h.generated for h in drain], pages_left=used)


# the agent's planes (grammar-constrained decode, partial holds): new tokens
# a stream, and the delay that stands in for a retrieval before the graft
AGENT_NEW = 64
RETRIEVAL_S = 0.2
# sat-out decode steps whose slots' pages are copied and compared whole (on
# every other one the slot's context length and last token are compared)
SAT_OUT_PAGE_CHECKS = 4


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def grammar_vocab(config, tok):
    """The tool grammar bound to the model's vocab through the reference's
    own constructor: ``ByteTokenizer``'s token texts, and an empty text (never
    allowed) for every id past them, so the masks are as wide as the head's
    logits rows."""
    from finchat_tpu_torch.agent.constrained import GrammarVocab, build_tool_grammar, token_texts

    texts = token_texts(tok)
    return GrammarVocab(build_tool_grammar(), texts + [""] * (config.vocab_size - len(texts)),
                        tok.eos_id)


def _page_tensors(engine) -> list:
    s = engine.state
    return [t for t in (s.k_pages, s.v_pages, s.k_scales, s.v_scales) if t is not None]


class _AgentProbe:
    """Instruments one scheduler for the constrained phase: which path each
    host pick took (the prefill round, the ragged round, a decode step's
    consume), the depth-2 dispatches a pending slot sat out and the depth-1
    dispatches (the loop's call of ``_dispatch_decode`` without
    ``exclude``), and around every decode step a slot sat out: its context
    length and last token unchanged, and for the first
    ``SAT_OUT_PAGE_CHECKS`` such steps every page of its context (K, V and
    scale planes) bit-identical across the step."""

    def __init__(self, torch, sched, engine):
        self.torch, self.sched, self.engine = torch, sched, engine
        self.where = [None]
        self.picks = {"prefill": 0, "ragged": 0, "decode": 0}
        self.sat_out_dispatches = self.depth1_dispatches = 0
        self.page_checks = self.scalar_checks = 0
        self.failures: list[str] = []

        def on(where, fn):
            async def wrapped(*a, **k):
                self.where[0] = where
                try:
                    return await fn(*a, **k)
                finally:
                    self.where[0] = None
            return wrapped

        sched._prefill_round = on("prefill", sched._prefill_round)
        sched._ragged_round = on("ragged", sched._ragged_round)
        sched._consume_step = on("decode", sched._consume_step)
        pick, dispatch, decode = sched._constrained_pick, sched._dispatch_decode, engine.decode

        def counting_pick(handle, row):
            self.picks[self.where[0]] += 1
            return pick(handle, row)

        def counting_dispatch(*a, **k):
            if not a and not k:
                self.depth1_dispatches += 1  # every decoding slot waited on a pick
            elif (a[0] if a else k["exclude"]):
                self.sat_out_dispatches += 1
            return dispatch(*a, **k)

        def checking_decode(active, *a, **k):
            out = [slot for slot in sched.decoding if not active[slot]]
            before = {}
            if out:
                _sync(torch)
                full = self.page_checks < SAT_OUT_PAGE_CHECKS
                for slot in out:
                    st = engine.state
                    ctx = int(st.context_lens[slot])
                    pages = sched.decoding[slot].page_list[: ctx // engine.page_size + 1]
                    idx = torch.tensor(pages, dtype=torch.long, device=st.k_pages.device)
                    before[slot] = (ctx, int(st.last_tokens[slot]), idx,
                                    [t[:, idx].clone() for t in _page_tensors(engine)]
                                    if full else None)
            result = decode(active, *a, **k)
            if out:
                _sync(torch)
                st = engine.state
                for slot, (ctx, last, idx, pages) in before.items():
                    if (int(st.context_lens[slot]), int(st.last_tokens[slot])) != (ctx, last):
                        self.failures.append(f"slot {slot} sat out a step and its context "
                                             f"length or last token moved")
                    if pages is not None and not all(
                            torch.equal(a_, t[:, idx]) for a_, t in zip(pages, _page_tensors(
                                engine))):
                        self.failures.append(f"slot {slot} sat out a step and a page of its "
                                             "context changed")
                    self.scalar_checks += 1
                if before[out[0]][3] is not None:
                    self.page_checks += 1
            return result

        sched._constrained_pick = counting_pick
        sched._dispatch_decode = counting_dispatch
        engine.decode = checking_decode

    def close(self) -> None:
        for name in ("_prefill_round", "_ragged_round", "_consume_step", "_constrained_pick",
                     "_dispatch_decode"):
            delattr(self.sched, name)
        del self.engine.decode


async def _run_to_end(handle) -> None:
    while True:
        event = await handle.events.get()
        if event["type"] == "done":
            return
        if event["type"] == "error":
            fail(f"{handle.seq_id}: {event['message']}")


def constrained_step_cost(torch, engine, vocab, context: int, active: int) -> dict:
    """What a constrained row adds to a decode step, on the engine's own
    state (random KV) at ``active`` slots of ``context`` tokens, host clock
    around work that ends in a synchronize: the decode step alone and the
    step with its logits and one row selected on the device and fetched, in
    turns, medians of 20 each; the fetch of one [vocab] fp32 row alone
    (median of 10); the host pick from it (the grammar's start state,
    median of 20; the first pick, which builds the state's mask, apart)."""
    import numpy as np

    from finchat_tpu_torch.agent.constrained import TokenConstraint

    B = engine.engine_cfg.max_seqs
    per = -(-(context + 8) // engine.page_size)
    engine.set_page_table_rows({s: list(range(1 + s * per, 1 + (s + 1) * per))
                                for s in range(active)})
    engine.set_context_lens_rows({s: context for s in range(active)})
    act = [s < active for s in range(B)]
    zeros, ones, izeros = [0.0] * B, [1.0] * B, [0] * B

    def once_ms(fn):
        t0 = time.perf_counter()
        fn()
        _sync(torch)
        return (time.perf_counter() - t0) * 1e3

    def median_ms(fn, n=10):
        fn()
        _sync(torch)
        return statistics.median(once_ms(fn) for _ in range(n))

    def plain():
        engine.decode(act, zeros, ones, izeros)

    rows = []

    def constrained():
        _tokens, logits = engine.decode(act, zeros, ones, izeros, return_logits=True)
        rows.append(engine.to_host(engine.select_rows(logits, [0])))

    # the host-bound step's time moves between steps: the two in turns
    # (plain, constrained, constrained, plain), medians of 20 each
    times: dict = {plain: [], constrained: []}
    for fn in (plain, constrained):
        fn()
    _sync(torch)
    for _ in range(10):
        for fn in (plain, constrained, constrained, plain):
            times[fn].append(once_ms(fn))
    plain_ms = statistics.median(times[plain])
    constrained_ms = statistics.median(times[constrained])
    row_dev = torch.randn((1, len(vocab.token_strs)), device=engine.device)
    fetch_ms = median_ms(lambda: engine.to_host(row_dev))
    row = rows[-1][0].astype(np.float32)
    rng = np.random.default_rng(0)
    vocab._mask_cache.pop(vocab.dfa.start, None)
    t0 = time.perf_counter()
    TokenConstraint(vocab).pick(row, 0.0, rng, remaining=AGENT_NEW)
    first_pick_ms = (time.perf_counter() - t0) * 1e3
    pick_ms = median_ms(lambda: TokenConstraint(vocab).pick(row, 0.0, rng, remaining=AGENT_NEW),
                        n=20)
    engine.reset_slots(list(range(active)))
    out = dict(active=active, context=context, decode_step_ms=plain_ms,
               decode_step_one_constrained_row_ms=constrained_ms, fetch_one_row_ms=fetch_ms,
               host_pick_ms=pick_ms, first_pick_ms=first_pick_ms)
    log(f"  constrained step cost: a decode step ({active} slots at {context} tokens) "
        f"{plain_ms:.3f} ms; with one constrained row (logits kept, the row selected on the "
        f"card and fetched) {constrained_ms:.3f} ms; the fetch of one row alone "
        f"{fetch_ms:.3f} ms; the host pick {pick_ms:.3f} ms (the first, building the state's "
        f"mask, {first_pick_ms:.3f} ms)")
    return out


async def agent_planes(torch, plane: str, spec: dict, config, engine, params, head_ids,
                       system_prompt: str, shared: int, partial: bool) -> dict:
    """The planes the agent rides on, at full width on the serve's engine and
    weights, on a scheduler of its own with the system head registered.

    Constrained decode: the tool grammar bound to the model's 128,256-wide
    vocab (``grammar_vocab``); four of the serve's requests run constrained
    (greedy, ``AGENT_NEW`` tokens at most) beside four plain ones: two plain
    and two constrained at once, two plain and one constrained once a first
    token streams, the last constrained one alone after them. Every path a
    constrained row takes must run (a pick in the prefill round, in the
    ragged round, at a decode step's consume; a constrained decode row of a
    ragged round; a depth-2 step a pending slot sat out; a depth-1 step),
    every constrained output must leave the grammar's DFA live or accepting
    and parse (``parse_tool_decision`` never raises), every plain stream pass
    the teacher-forced check and every constrained one the masked one, every
    page of a slot that sat out a step stay unchanged across it
    (``_AgentProbe``), and the window keep the serve's launch rules (the
    plane's Hopper bodies, no older one). Then ``constrained_step_cost``.

    Partial holds (with ``partial``): for two of the serve's prompts, a
    plain submit, then ``submit_partial`` of the rendered head plus context,
    parked, grafted by ``extend_prompt`` after ``RETRIEVAL_S``: the grafted
    stream must pass the teacher-forced check and ``finchat_partial_grafts_total``
    rise by one a graft; TTFT from the graft is printed beside the plain
    submit's. A divergent graft must return False, and its cancel give back
    every own page with the head's refcount unchanged."""
    from finchat_tpu_torch.agent.constrained import DEAD, TokenConstraint
    from finchat_tpu_torch.agent.toolcall import parse_tool_decision
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    tok = ByteTokenizer()
    t0 = time.perf_counter()
    vocab = grammar_vocab(config, tok)
    vocab_s = time.perf_counter() - t0
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    if sched.register_prefix(head_ids) != shared:
        fail(f"agent planes ({plane}): the head did not register")
    entry = sched._prefixes[0]
    head_pages = len(entry.pages)
    prompts = [tok.encode(render_chat(system_prompt, CONTEXTS[i], [], MESSAGES[i]), add_bos=True)
               for i in range(8)]
    plain_s = SamplingParams(temperature=0.0, max_new_tokens=AGENT_NEW)
    grammar_s = SamplingParams(temperature=0.0, max_new_tokens=AGENT_NEW, grammar="tool_call")
    log(f"  constrained decode ({plane}): the tool grammar bound to {len(vocab.token_strs)} "
        f"tokens in {vocab_s:.2f} s ({len(vocab.dfa.edges)} DFA states); 4 constrained and 4 "
        f"plain requests over the head, {AGENT_NEW} new tokens at most")
    counts = _Counts(engine)
    probe = _AgentProbe(torch, sched, engine)
    handles: dict[int, object] = {}

    async def run(i: int, constrained: bool):
        h = await sched.submit(f"{'grammar' if constrained else 'plain'}-{plane}-{i}",
                               prompts[i], grammar_s if constrained else plain_s,
                               constraint=TokenConstraint(vocab) if constrained else None)
        handles[i] = h
        await _run_to_end(h)

    constrained_ids = (2, 3, 5, 7)
    m0 = METRICS.snapshot()
    reset_launches()
    TRACER.clear()
    await sched.start()
    try:
        t_start = time.perf_counter()
        wave1 = [asyncio.create_task(run(i, i in constrained_ids)) for i in (0, 1, 2, 3)]
        while not any(h.generated > 0 for h in handles.values()):
            await asyncio.sleep(0.005)
        wave2 = [asyncio.create_task(run(i, i in constrained_ids)) for i in (4, 5, 6)]
        await asyncio.gather(*wave1, *wave2)
        await run(7, True)  # alone: the prefill round's pick and the depth-1 branch
        _sync(torch)
        wall = time.perf_counter() - t_start
    finally:
        await sched.stop()
    launches = dict(LAUNCHES)
    probe.close()
    ragged_constrained_rows = sum(
        1 for ev in TRACER.snapshot() if ev[2] == "dispatch" and ev[5]["kind"] == "ragged"
        for r in ev[5]["rows"] if r[2] == "constrained")
    outputs = {}
    for i in constrained_ids:
        h = handles[i]
        text = tok.decode([t for t in h.history[len(h.prompt_ids):] if t != tok.eos_id])
        state = vocab.dfa.step_string(vocab.dfa.start, text)
        try:
            call = parse_tool_decision(text)
        except Exception as e:
            fail(f"constrained decode ({plane}): parse_tool_decision raised {e!r} on {text!r}")
        if state == DEAD:
            fail(f"constrained decode ({plane}): {h.seq_id} left the grammar: {text!r}")
        outputs[h.seq_id] = dict(text=text, tokens=h.generated,
                                 accepting=bool(vocab.dfa.eos_ok[state]),
                                 call=None if call is None else [call.name, call.args])
    log(f"  constrained decode ({plane}): 8 streams in {wall:.2f} s; outputs "
        + json.dumps(outputs))
    log(f"  constrained decode ({plane}): picks by path {probe.picks}; constrained decode rows "
        f"in ragged rounds {ragged_constrained_rows}; depth-2 steps a pending slot sat out "
        f"{probe.sat_out_dispatches}, depth-1 steps {probe.depth1_dispatches}; sat-out slots "
        f"checked {probe.scalar_checks} (context and last token), {probe.page_checks} steps "
        "with every page compared")
    if probe.failures:
        fail(f"constrained decode ({plane}): {probe.failures[:4]}")
    if (min(probe.picks.values()) < 1 or ragged_constrained_rows < 1
            or probe.sat_out_dispatches < 1 or probe.depth1_dispatches < 1
            or probe.page_checks < 1):
        fail(f"constrained decode ({plane}): a path of the constrained rows did not run")
    for h in handles.values():
        _stream_ended(plane, "constrained decode", h, tok.eos_id)
    decode_steps = _metric_delta(METRICS, m0, "finchat_decode_dispatches_total")
    rounds = _metric_delta(METRICS, m0, "finchat_mixed_dispatches_total")
    missing = [k for k in spec["kernels"] if launches[k] == 0]
    if missing:
        fail(f"constrained decode ({plane}): kernels not launched: {missing}")
    check_window(plane, "constrained decode", spec, config, launches, counts, decode_steps,
                 rounds)
    checks = [teacher_forced_check(torch, params, config, handles[i], spec["kv_quant"],
                                   vocab=vocab if i in constrained_ids else None)
              for i in sorted(handles)]
    cost = constrained_step_cost(torch, engine, vocab, SERVE_CONTEXT, 8)
    out = dict(wall_s=wall, vocab_build_s=vocab_s, outputs=outputs, picks=probe.picks,
               ragged_constrained_rows=ragged_constrained_rows,
               sat_out_dispatches=probe.sat_out_dispatches,
               depth1_dispatches=probe.depth1_dispatches, page_checks=probe.page_checks,
               scalar_checks=probe.scalar_checks, teacher_forced=checks, step_cost=cost,
               launches={k: v for k, v in launches.items() if v})
    if partial:
        out["partial"] = await partial_holds(torch, plane, spec, config, params, sched, entry,
                                             head_pages, system_prompt)
    counts.close()
    sched.retire_prefixes()
    if sched.allocator.used_count != 0:
        fail(f"agent planes ({plane}): {sched.allocator.used_count} KV pages still allocated")
    if sched.session_cache is not None and sched.session_cache.disk is not None:
        sched.session_cache.disk.close()
    return out


async def partial_holds(torch, plane, spec, config, params, sched, entry, head_pages: int,
                        system_prompt: str) -> dict:
    """The retrieval overlap at full width (see ``agent_planes``)."""
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat, render_chat_prefix
    from finchat_tpu_torch.utils.metrics import METRICS

    tok = ByteTokenizer()
    greedy = SamplingParams(temperature=0.0, max_new_tokens=AGENT_NEW)
    rows = []
    checks = []
    await sched.start()
    try:
        for i in (0, 1):
            full = tok.encode(render_chat(system_prompt, CONTEXTS[i], [], MESSAGES[i]),
                              add_bos=True)
            # the prefix as the generator takes it: BOS added, the last token
            # dropped (it could merge across the graft)
            prefix = tok.encode(render_chat_prefix(system_prompt, CONTEXTS[i], []),
                                add_bos=True)[:-1]
            if full[: len(prefix)] != prefix:
                fail(f"partial holds ({plane}): the rendered prefix does not lead the prompt")
            plain = await sched.submit(f"plain-{plane}-p{i}", full, greedy)
            await _run_to_end(plain)
            g0 = METRICS.get("finchat_partial_grafts_total")
            hold = await sched.submit_partial(f"hold-{plane}-{i}", prefix, greedy)
            if hold is None:
                fail(f"partial holds ({plane}): submit_partial refused the prefix")
            t_park = time.perf_counter()
            while not (hold.slot >= 0 and hold.prefill_pos >= len(hold.prompt_ids)):
                await asyncio.sleep(0.002)
            parked_s = time.perf_counter() - t_park
            await asyncio.sleep(RETRIEVAL_S)  # the retrieval
            t_graft = time.perf_counter()
            if not sched.extend_prompt(hold, full):
                fail(f"partial holds ({plane}): the graft was refused")
            graft_host_s = time.perf_counter() - t_graft
            await _run_to_end(hold)
            grafts = METRICS.get("finchat_partial_grafts_total") - g0
            row = dict(prompt_tokens=len(full), prefix_tokens=len(prefix),
                       shared=hold.shared_len, parked_after_s=parked_s,
                       graft_host_s=graft_host_s,
                       ttft_from_graft_s=hold.first_token_at - t_graft,
                       plain_ttft_s=plain.first_token_at - plain.submitted_at,
                       grafts=grafts, same_tokens_as_plain=hold.history == plain.history)
            log(f"  partial hold {i} ({plane}): prompt {len(full)} tokens, prefix {len(prefix)} "
                f"({hold.shared_len} on the head) parked {parked_s:.3f} s after submit; graft "
                f"{graft_host_s * 1e3:.3f} ms on the host; TTFT from the graft "
                f"{row['ttft_from_graft_s']:.3f} s against a plain submit's "
                f"{row['plain_ttft_s']:.3f} s; grafts +{grafts:.0f}; tokens equal the plain "
                f"submit's: {row['same_tokens_as_plain']}")
            if grafts != 1 or not hold.grafted:
                fail(f"partial holds ({plane}): finchat_partial_grafts_total rose by {grafts}")
            checks.append(teacher_forced_check(torch, params, config, hold, spec["kv_quant"]))
            rows.append(row)
        # a divergent graft: refused, and its cancel gives every own page back
        prefix = tok.encode(render_chat_prefix(system_prompt, CONTEXTS[2], []), add_bos=True)[:-1]
        refs0, used0 = entry.refs, sched.allocator.used_count
        hold = await sched.submit_partial(f"diverge-{plane}", prefix, greedy)
        while not (hold.slot >= 0 and hold.prefill_pos >= len(hold.prompt_ids)):
            await asyncio.sleep(0.002)
        own = len(sched.allocator.owned_by(hold.seq_id))
        refused = not sched.extend_prompt(hold, [tok.bos_id] + prefix + [65])
        sched.cancel(hold)
        left = len(sched.allocator.owned_by(hold.seq_id))
        log(f"  divergent graft ({plane}): refused {refused}; the hold owned {own} pages, "
            f"{left} after its cancel; the head's refcount {refs0} -> {entry.refs}; "
            f"{sched.allocator.used_count} pages allocated (before it {used0}, the head's "
            f"{head_pages})")
        if not refused or left or entry.refs != refs0 or sched.allocator.used_count != used0:
            fail(f"partial holds ({plane}): the divergent graft leaked or was taken")
    finally:
        await sched.stop()
    return dict(holds=rows, teacher_forced=checks, divergent_own_pages=own)


# the agent's turns (``agent_turns``): new tokens at most for the decision (the
# response takes ``AGENT_NEW``), the fake retriever's rows (after
# ``RETRIEVAL_S``), the date the prompts carry, and the stub decision of the
# overlap comparison, paced a word every ``STUB_WORD_S`` (its search query
# commits on the second word)
DECISION_NEW = 96
TURN_ROWS = [
    "2026-07-30 COFFEE CORNER -4.50 dining",
    "2026-07-29 FRESH MARKET -86.12 groceries",
    "2026-07-28 CITY TRANSIT -2.75 transport",
    "2026-07-27 NOODLE BAR -23.40 dining",
    "2026-07-25 PAYROLL +3100.00 income",
    "2026-07-24 STREAMING CO -15.99 subscriptions",
    "2026-07-21 FRESH MARKET -64.30 groceries",
    "2026-07-01 LANDLORD LLC -1850.00 rent",
]
AGENT_DAY = "2026-08-03"
STUB_DECISION = 'retrieve_transactions({"search_query": "dining", "num_transactions": 20})'
STUB_WORD_S = 0.1


class _TurnRetriever:
    """The agent's fake retriever: ``RETRIEVAL_S`` of latency, then
    ``TURN_ROWS``. With ``structured`` (given only where matplotlib is
    installed) it also serves a plot call's rows, each with an amount."""

    def __init__(self, structured: bool):
        self.calls: list[dict] = []
        if structured:
            self.structured = self._structured

    async def __call__(self, args):
        self.calls.append(dict(args))
        await asyncio.sleep(RETRIEVAL_S)
        return list(TURN_ROWS)

    async def _structured(self, args):
        self.calls.append(dict(args))
        await asyncio.sleep(RETRIEVAL_S)
        return [dict(page_content=row, amount=float(i + 1), date=float(i))
                for i, row in enumerate(TURN_ROWS)]


def check_turn_protocol(plane: str, what: str, events: list) -> tuple[bool, int]:
    """One ``stream_with_status`` turn against the reference's protocol: the
    two opening statuses; then the retrieval status, ``retrieval_complete``
    (and a plot event where a chart was drawn), or the no-retrieval status;
    then "Generating response...", only response chunks, and ``complete``.
    Returns whether the turn retrieved, and its row count."""
    status = [{"type": "status", "message": m} for m in (
        "Starting query processing...",
        "Analyzing query to determine if transaction data is needed...",
        "Retrieving relevant transaction data...", "No transaction data retrieval needed",
        "Generating response...")]
    complete = {"type": "complete", "message": "Query processing completed"}
    ok = events[:2] == status[:2] and status[4] in events and events[-1] == complete
    retrieved, count = False, 0
    if ok:
        g = events.index(status[4])
        middle = events[2:g]
        ok = all(e["type"] == "response_chunk" and e["content"] for e in events[g + 1:-1])
        retrieved = bool(middle) and middle[0] == status[2]
        if retrieved:
            rc = middle[1] if len(middle) > 1 else {}
            count = rc.get("count", -1)
            plot = middle[2:]
            ok = ok and rc == {"type": "retrieval_complete", "count": count,
                               "message": f"Retrieved {count} transactions"} and (
                not plot or (len(plot) == 1 and plot[0]["type"] == "plot"
                             and plot[0]["data_uri"].startswith("data:image/png;base64,")))
        else:
            ok = ok and middle == [status[3]]
    if not ok:
        fail(f"agent turns ({plane}, {what}): the events break the protocol: "
             + json.dumps([e if e["type"] != "plot" else {"type": "plot"} for e in events])[:2000])
    return retrieved, count


def _turn_handles(handles, conv: str) -> tuple:
    """The decision handle and the response handle (the grafted hold, or the
    plain submit) of the turn of ``conv``, by their session keys."""
    tool = [h for h in handles if h.conversation_id == f"{conv}#tool"]
    resp = [h for h in handles if h.conversation_id == f"{conv}#resp"]
    return (tool[-1] if tool else None), (resp[-1] if resp else None), resp


def _marks(tracer, trace_id: str) -> dict:
    """The agent's marks of one turn on the trace: name -> first ts."""
    out = {}
    for ev in tracer.snapshot():
        if ev[1] == trace_id and ev[2] not in out:
            out[ev[2]] = ev[0]
    return out


def _wait_for(cond, what: str, limit_s: float = 10.0):
    async def waiter():
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > limit_s:
                fail(what)
            await asyncio.sleep(0.005)
    return waiter()


async def agent_turns(torch, plane: str, spec: dict, config, engine, params, system_prompt: str,
                      pairs: int, overlap_runs: bool, retrieval: dict | None = None) -> dict:
    """Penny turns through the port's ``LLMAgent`` at full width, on the
    serve's engine and weights, on a scheduler of its own at
    ``EngineConfig()`` with both ``agent.prompt_heads()`` registered (BOS
    added, the last token dropped, as the app registers them). The prompts
    are the repo's ``prompts/``; everything is greedy, at most
    ``DECISION_NEW`` tokens for the decision and ``AGENT_NEW`` for the
    response; every turn is its own conversation and user, traced.

    1. Engine-decided: both roles are one ``EngineGenerator`` over the model,
       whose ``ByteTokenizer`` is as wide as the logits rows (its texts past
       the bytes are empty), so the decision's ``tool_call`` grammar binds to
       all 128,256 ids. ``pairs`` pairs of turns, two at a time, over the fake
       retriever. Each turn's events must follow the reference's protocol;
       the decision text must leave the DFA accepting, and the streamed
       parser (recorded) must end with no anomaly and agree with
       ``parse_tool_decision``; the decision passes the teacher-forced check
       under its grammar mask, the response the plain one;
       ``finchat_partial_grafts_total`` must rise by one a turn that
       retrieved (the hold taken at name-commit, before the decision's last
       token) and the pages after the turns equal those before.
    2. With ``overlap_runs``: the decision from a ``StubGenerator`` paced a
       word every ``STUB_WORD_S`` whose search query commits on its second
       word, the response on the engine; the same two turns with
       ``retrieval_overlap`` and ``tool_streaming`` on, then both off, over
       ``retrieval``'s real ``TransactionRetriever`` where given (the
       ``retrieval_phase``'s bf16 index of 262,144 rows; each turn a corpus
       user, its count the plain search's for its arguments), else the
       fake one. The responses must be byte-identical; with them on, the tool must launch
       once a turn and be adopted (no cancel, no fallback, the
       ``tool_adopted`` mark), the hold taken at name-commit (the
       ``name_commit`` then ``response_prefill_hold`` marks, before the
       stub's decode ended) and grafted; with them off, nothing launches or
       holds. Every response of both runs passes the teacher-forced check. The response TTFT from the turn's start, on and off, and
       ``finchat_tool_overlap_saved_seconds`` are printed.
    3. With ``overlap_runs``: an abandoned turn. Its consumer goes away once
       the response has its first token (the task iterating
       ``stream_with_status`` is cancelled, as a client disconnect does, and
       the generator closed): no hold, slot or own page may be left, and
       the heads' refcounts must be as before.

    Launch counts are set to 0 after the registrations and read after part
    2: every kernel of the plane must have launched, under the serve's launch
    rules (``check_window``)."""

    import finchat_tpu_torch.agent.graph as graph_mod
    from finchat_tpu_torch.agent import LLMAgent
    from finchat_tpu_torch.agent.constrained import DEAD
    from finchat_tpu_torch.agent.toolcall import parse_tool_decision
    from finchat_tpu_torch.engine.generator import EngineGenerator, StubGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    matplotlib = importlib.util.find_spec("matplotlib") is not None
    tok = ByteTokenizer(vocab_size=config.vocab_size)
    tool_prompt = (REPO / "prompts" / "tool_prompt.txt").read_text()
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    gen = EngineGenerator(sched, tok)
    handles: list = []
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    sched.submit = recording_submit
    decision_s = SamplingParams(temperature=0.0, max_new_tokens=DECISION_NEW, grammar="tool_call")
    response_s = SamplingParams(temperature=0.0, max_new_tokens=AGENT_NEW)

    def make_agent(tool_gen, retriever, on: bool = True):
        return LLMAgent(tool_gen, gen, retriever, system_prompt, tool_prompt,
                        tool_sampling=decision_s, response_sampling=response_s,
                        today=lambda: AGENT_DAY, retrieval_overlap=on, tool_streaming=on)

    heads = make_agent(gen, None).prompt_heads()
    shared = [sched.register_prefix(tok.encode(head, add_bos=True)[:-1]) for head in heads]
    if not all(shared) or len(sched._prefixes) != 2:
        fail(f"agent turns ({plane}): the two prompt heads registered {shared}")
    entries = list(sched._prefixes)
    head_pages = sum(len(e.pages) for e in entries)
    log(f"  agent turns ({plane}): prompt heads of {shared} shared tokens ({head_pages} pages) "
        f"registered; matplotlib on this machine: {matplotlib} (the fake retriever "
        f"{'serves' if matplotlib else 'has no'} structured rows for a plot call)")
    parsers: list = []
    base_parser = graph_mod.StreamingToolParser

    class RecordingParser(base_parser):
        """The agent's streaming parser, kept for the checks."""

        def __init__(self):
            super().__init__()
            self.final = "unfinished"
            parsers.append(self)

        def finish(self):
            self.final = super().finish()
            return self.final

    async def turn(agent, i: int, conv: str, user: str | None = None) -> dict:
        t0 = time.perf_counter()
        user = user or f"user-{conv}"
        events = [ev async for ev in agent.stream_with_status(
            MESSAGES[i], user, CONTEXTS[i], [], conversation_id=conv, trace_id=conv)]
        return dict(conv=conv, i=i, t0=t0, events=events, user=user)

    counts = _Counts(engine)
    m0 = METRICS.snapshot()
    reset_launches()
    TRACER.clear()
    graph_mod.StreamingToolParser = RecordingParser
    out: dict = dict(matplotlib=matplotlib, shared=shared)
    t_phase = time.perf_counter()
    await sched.start()
    try:
        # 1. engine-decided turns, two at a time
        used0 = sched.allocator.used_count
        g0 = METRICS.get("finchat_partial_grafts_total")
        retriever = _TurnRetriever(structured=matplotlib)
        agent = make_agent(gen, retriever)
        if agent.metrics is not sched.metrics:
            fail(f"agent turns ({plane}): the agent's registry is not its scheduler's")
        t_start = time.perf_counter()
        turns = []
        for p in range(pairs):
            turns += await asyncio.gather(*(turn(agent, i, f"agent-{plane}-{i}")
                                            for i in (2 * p, 2 * p + 1)))
        _sync(torch)
        wall = time.perf_counter() - t_start
        await _wait_for(lambda: sched.allocator.used_count == used0 and not sched.decoding
                        and not sched.prefilling,
                        f"agent turns ({plane}): {sched.allocator.used_count} pages allocated "
                        f"after the turns, not the heads' {used0}")
        grafts = METRICS.get("finchat_partial_grafts_total") - g0
        vocab = await gen._grammar_vocabs["tool_call"]
        if len(vocab.token_strs) != config.vocab_size:
            fail(f"agent turns ({plane}): the grammar is {len(vocab.token_strs)} ids wide")
        rows, checks, n_retrieved = [], [], 0
        for t in turns:
            retrieved, count = check_turn_protocol(plane, t["conv"], t["events"])
            decision, response, _all = _turn_handles(handles, t["conv"])
            if decision is None or response is None:
                fail(f"agent turns ({plane}): {t['conv']} has no decision or response handle")
            _stream_ended(plane, "agent turns", decision, tok.eos_id)
            _stream_ended(plane, "agent turns", response, tok.eos_id)
            text = tok.decode([x for x in decision.history[len(decision.prompt_ids):]
                               if x != tok.eos_id])
            state = vocab.dfa.step_string(vocab.dfa.start, text)
            if state == DEAD or not vocab.dfa.eos_ok[state]:
                fail(f"agent turns ({plane}): {t['conv']}'s decision leaves the grammar "
                     f"unaccepted: {text!r}")
            call = parse_tool_decision(text)
            if (call is not None) != retrieved:
                fail(f"agent turns ({plane}): {t['conv']} retrieved {retrieved}, its decision "
                     f"parses to {call}")
            n_retrieved += retrieved
            hold_lead = None
            if retrieved:
                # the hold submitted at name-commit, before the decision's last token
                marks = _marks(TRACER, t["conv"])
                if not (response.grafted and "name_commit" in marks
                        and "response_prefill_hold" in marks
                        and response.submitted_at < decision.last_token_at):
                    fail(f"agent turns ({plane}): {t['conv']}'s response hold was not taken "
                         f"at name-commit and grafted: marks {sorted(marks)}")
                hold_lead = decision.last_token_at - response.submitted_at
            checks.append(teacher_forced_check(torch, params, config, decision,
                                               spec["kv_quant"], vocab=vocab))
            checks.append(teacher_forced_check(torch, params, config, response,
                                               spec["kv_quant"]))
            ttft = response.first_token_at - t["t0"]
            rows.append(dict(conv=t["conv"], decision=text, decision_tokens=decision.generated,
                             decision_s=decision.last_token_at - decision.submitted_at,
                             call=None if call is None else [call.name, call.args],
                             retrieved=retrieved, rows=count, hold_lead_s=hold_lead,
                             grafted=response.grafted, response_tokens=response.generated,
                             ttft_from_turn_start_s=ttft,
                             chunks=sum(e["type"] == "response_chunk" for e in t["events"])))
            log(f"  agent turn {t['conv']} ({plane}): decision {decision.generated} tokens in "
                f"{rows[-1]['decision_s']:.3f} s: {text!r}; retrieved {retrieved} ({count} rows)"
                + (f"; hold taken {hold_lead:.3f} s before the decision's last token, grafted"
                   if retrieved else "")
                + f"; response {response.generated} tokens, {rows[-1]['chunks']} text chunks, "
                f"TTFT from the turn's start {ttft:.3f} s")
        recorded = sorted((p.text, repr(p.final), p.anomaly) for p in parsers)
        want = sorted((r["decision"], repr(parse_tool_decision(r["decision"])), None)
                      for r in rows)
        if recorded != want or any(p.completed_call is not None and p.completed_call != p.final
                                   for p in parsers):
            fail(f"agent turns ({plane}): the streamed parsers {recorded} do not agree with "
                 f"parse_tool_decision over the decisions {want}")
        log(f"  agent turns ({plane}): {len(turns)} engine-decided turns in {wall:.2f} s; "
            f"{n_retrieved} retrieved, partial grafts +{grafts:.0f}; pages after the turns "
            f"{sched.allocator.used_count} (before {used0}); the streamed parsers agree with "
            "parse_tool_decision")
        if grafts != n_retrieved:
            fail(f"agent turns ({plane}): finchat_partial_grafts_total rose by {grafts}, "
                 f"{n_retrieved} turns retrieved")
        out.update(engine_turns=rows, engine_wall_s=wall, grafts=grafts, teacher_forced=checks)
        if overlap_runs:
            out["overlap"] = await _overlap_runs(torch, plane, spec, config, params, sched,
                                                 handles, turn, make_agent, StubGenerator,
                                                 retrieval)
        launches = dict(LAUNCHES)
        decode_steps = _metric_delta(METRICS, m0, "finchat_decode_dispatches_total")
        rounds = _metric_delta(METRICS, m0, "finchat_mixed_dispatches_total")
        missing = [k for k in spec["kernels"] if launches[k] == 0]
        if missing:
            fail(f"agent turns ({plane}): kernels not launched: {missing}")
        check_window(plane, "agent turns", spec, config, launches, counts, decode_steps, rounds)
        out["launches"] = {k: v for k, v in launches.items() if v}
        if overlap_runs:
            out["abandoned"] = await _abandoned_turn(plane, sched, handles, entries, make_agent,
                                                     StubGenerator)
    finally:
        graph_mod.StreamingToolParser = base_parser
        await sched.stop()
        sched.submit = submit
        counts.close()
    sched.retire_prefixes()
    if sched.allocator.used_count != 0:
        fail(f"agent turns ({plane}): {sched.allocator.used_count} KV pages still allocated")
    if sched.session_cache is not None and sched.session_cache.disk is not None:
        sched.session_cache.disk.close()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  agent turns ({plane}): the phase took {out['phase_s']:.1f} s")
    return out


def _paced_stub(stub_cls):
    """A ``StubGenerator`` decision paced a word every ``STUB_WORD_S``; its
    ``ended`` lists when each of its streams ended (the decode's end)."""

    class Paced(stub_cls):
        def __init__(self):
            super().__init__(default=STUB_DECISION, chunk_delay=STUB_WORD_S)
            self.ended: list[float] = []

        async def stream(self, *a, **k):
            async for piece in super().stream(*a, **k):
                yield piece
            self.ended.append(time.perf_counter())

    return Paced()


async def _overlap_runs(torch, plane, spec, config, params, sched, handles, turn, make_agent,
                        stub_cls, retrieval: dict | None = None) -> dict:
    """Part 2 of ``agent_turns``: the same two turns with the overlap and tool
    streaming on, then off; over ``retrieval``'s real retriever where given
    (each turn a corpus user, the same on and off), whose reported count
    must be the plain search's for the stub's arguments."""
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    counters = ("finchat_tool_launches_total", "finchat_tool_speculative_cancels_total",
                "finchat_tool_fallbacks_total", "finchat_partial_holds_total",
                "finchat_partial_grafts_total")
    runs = {}
    for on in (True, False):
        m0 = METRICS.snapshot()
        stub = _paced_stub(stub_cls)
        real = retrieval["retriever"] if retrieval else None
        agent = make_agent(stub, real or _TurnRetriever(structured=False), on=on)
        name = "on" if on else "off"
        turns = await asyncio.gather(*(turn(agent, i, f"stub-{plane}-{name}-{i}",
                                            retrieval["users"][i] if real else None)
                                       for i in (0, 1)))
        delta = {c: _metric_delta(METRICS, m0, c) for c in counters}
        saved = _seconds(METRICS, m0, "finchat_tool_overlap_saved_seconds")
        rows = []
        for t in turns:
            retrieved, count = check_turn_protocol(plane, t["conv"], t["events"])
            _d, response, _all = _turn_handles(handles, t["conv"])
            if not retrieved or response is None:
                fail(f"agent turns ({plane}): the stub turn {t['conv']} did not retrieve")
            if real is not None:
                stub_args = json.loads(STUB_DECISION[len("retrieve_transactions("):-1])
                plain = plain_count(real.index, {**stub_args, "user_id": t["user"]},
                                    retrieval["now"])
                if count != plain:
                    fail(f"agent turns ({plane}): {t['conv']} retrieved {count} rows of "
                         f"{t['user']}, the plain search {plain}")
            marks = _marks(TRACER, t["conv"])
            text = "".join(e["content"] for e in t["events"] if e["type"] == "response_chunk")
            rows.append(dict(conv=t["conv"], text=text, rows=count, user=t["user"],
                             prompt=list(response.prompt_ids),
                             tokens=response.history[len(response.prompt_ids):],
                             grafted=response.grafted, ttft_s=response.first_token_at - t["t0"],
                             marks={k: v - t["t0"] for k, v in marks.items()}))
            if on:
                ok = (response.grafted and "tool_adopted" in marks and "tool_launch" in marks
                      and marks.get("name_commit", 1e18) <= marks.get("response_prefill_hold", 0)
                      < min(e for e in stub.ended if e > t["t0"]))
            else:
                ok = not response.grafted and not ({"tool_launch", "response_prefill_hold"}
                                                   & set(marks))
            if not ok:
                fail(f"agent turns ({plane}): overlap {name}: {t['conv']}'s marks "
                     f"{rows[-1]['marks']} (grafted {response.grafted})")
        checks = [teacher_forced_check(torch, params, config, _turn_handles(handles, t["conv"])[1],
                                       spec["kv_quant"], with_margins=True) for t in turns]
        for r, c in zip(rows, checks):
            r["margins"] = c.pop("margins")
        want = (dict(finchat_tool_launches_total=2, finchat_tool_speculative_cancels_total=0,
                     finchat_tool_fallbacks_total=0, finchat_partial_holds_total=2,
                     finchat_partial_grafts_total=2) if on else {c: 0 for c in counters})
        if delta != want or saved["n"] != (2 if on else 0):
            fail(f"agent turns ({plane}): overlap {name}: counters {delta}, overlap-saved "
                 f"observations {saved['n']} (want {want}, {2 if on else 0})")
        runs[name] = dict(turns=rows, counters=delta, overlap_saved=saved, teacher_forced=checks)
        log(f"  agent overlap {name} ({plane}): response TTFT from the turn's start "
            + ", ".join(f"{r['ttft_s']:.3f}" for r in rows) + " s; marks (s from the turn's "
            "start) " + json.dumps([{k: round(v, 4) for k, v in r["marks"].items()
                                     if k != "dispatch"} for r in rows])
            + f"; counters {delta}; finchat_tool_overlap_saved_seconds {saved['n']} "
            f"observations, {saved['total_s']:.3f} s in all")
    same_text = [a["text"] == b["text"] for a, b in zip(runs["on"]["turns"], runs["off"]["turns"])]
    same_tokens = [a["tokens"] == b["tokens"]
                   for a, b in zip(runs["on"]["turns"], runs["off"]["turns"])]
    # where the greedy ids part (both streams passed the teacher-forced check)
    first_diff = [next((k for k, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y),
                       None) for a, b in zip(runs["on"]["turns"], runs["off"]["turns"])]
    # where they part: are the grafted and the plain response prompts the
    # same bytes (a graft fault if not), and how close was the plain
    # forward's top-2 at that token (a near tie after another chunking if so)
    same_prompts = [a["prompt"] == b["prompt"]
                    for a, b in zip(runs["on"]["turns"], runs["off"]["turns"])]
    margin_at_diff = [None if n is None else a["margins"][n]
                      for n, a in zip(first_diff, runs["on"]["turns"])]
    log(f"  agent overlap ({plane}): responses byte-identical on and off: {same_text}; token "
        f"ids identical: {same_tokens} (first different id at {first_diff}); grafted and plain "
        f"response prompts byte-equal: {same_prompts}; the plain forward's top-2 margin at "
        f"the first different id (on the overlap-on stream): {margin_at_diff}")
    if not all(same_text):
        fail(f"agent turns ({plane}): the responses differ with the overlap on and off")
    for run in runs.values():
        for r in run["turns"]:
            r.pop("tokens")
            r.pop("prompt")
            r.pop("margins")
    return dict(runs=runs, byte_identical=same_text, token_identical=same_tokens,
                first_different_id=first_diff, prompts_equal=same_prompts,
                margin_at_first_difference=margin_at_diff)


async def _abandoned_turn(plane, sched, handles, entries, make_agent, stub_cls) -> dict:
    """Part 3 of ``agent_turns``: a turn whose consumer goes away once the
    response has its first token."""
    free0, used0 = len(sched.free_slots), sched.allocator.used_count
    refs0 = [e.refs for e in entries]
    conv = f"abandoned-{plane}"
    agent = make_agent(stub_cls(default=STUB_DECISION), _TurnRetriever(structured=False))
    stream = agent.stream_with_status(MESSAGES[3], "user-abandoned", CONTEXTS[3], [],
                                      conversation_id=conv)
    seen: list = []

    async def consume():
        async for ev in stream:
            seen.append(ev["type"])

    task = asyncio.create_task(consume())

    def started():
        _d, response, _all = _turn_handles(handles, conv)
        return task.done() or (response is not None and response.generated >= 1)

    await _wait_for(started, f"agent turns ({plane}): the abandoned turn's response never "
                             "started")
    if task.done():
        fail(f"agent turns ({plane}): the abandoned turn ended before it was abandoned: {seen}")
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        pass
    await stream.aclose()
    _d, response, mine = _turn_handles(handles, conv)
    await _wait_for(lambda: all(h.finished for h in mine) and not sched.decoding
                    and not sched.prefilling and not sched.pending
                    and sched.allocator.used_count == used0,
                    f"agent turns ({plane}): the abandoned turn left work or pages: "
                    f"{sched.allocator.used_count} pages (before {used0})")
    own = sum(len(sched.allocator.owned_by(h.seq_id)) for h in mine)
    refs = [e.refs for e in entries]
    held = [h.seq_id for h in mine if h.held]
    log(f"  agent abandoned turn ({plane}): consumer cancelled after {seen} with the response at "
        f"{response.generated} tokens (grafted {response.grafted}); {len(mine)} handles, all "
        f"finished, {own} own pages, {len(held)} holds left; free slots {len(sched.free_slots)} "
        f"(before {free0}); the heads' refcounts {refs0} -> {refs}; {sched.allocator.used_count} "
        f"pages allocated (before {used0})")
    if own or held or refs != refs0 or len(sched.free_slots) != free0 or not response.grafted:
        fail(f"agent turns ({plane}): the abandoned turn leaked a hold, slot, page or head "
             "reference")
    return dict(events_seen=seen, response_tokens=response.generated, own_pages=own,
                refs=refs)


# the app's turns (``app_turns``): four conversations over the in-memory
# broker and store, turn 2 of two of them, a redelivery, one HTTP turn
# --------------------------------------------------------------------------
# retrieval: the encoder, the index, the microbatcher and the retriever
# --------------------------------------------------------------------------

# the int8 encoder's weight shapes at bge-base-en's widths ([K, N]), in its
# two regimes: an ingest dispatch of 32 texts in a 64-token bucket (M=2048,
# the Hopper kernel) and a lone query in its 32-token bucket (M=32, the
# decode body)
BGE_QMM_ROWS = (2048, 32)
BGE_QMM_WEIGHTS = {"qkv": (768, 2304), "attn_out": (768, 768), "mlp_in": (768, 3072),
                   "mlp_out": (3072, 768)}
RETRIEVAL_USERS = 64
RETRIEVAL_TEXTS = 4096
RETRIEVAL_ROWS = 262_144
RETRIEVAL_OTHER_USERS = 1024
# texts an upsert call: four calls fill one 32-text dispatch of the batcher
INGEST_CALL_TEXTS = 8
# a reference hit whose score is within SCORE_TIE of a neighbour's may come in
# either order (the card sums in fp32); the bf16/int8 ranking gate takes a
# pick within RANK_EPS of the rank-K boundary as a near tie (the rule of
# tests/test_quant_serving.py's quantized-encoder gate)
SCORE_TIE = 1e-5
RANK_K, RANK_EPS = 10, 2e-3
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (TF32 off)
MERCHANTS = (("COFFEE CORNER", "dining"), ("NOODLE BAR", "dining"), ("FRESH MARKET", "groceries"),
             ("CORNER GROCER", "groceries"), ("CITY TRANSIT", "transport"),
             ("RIDE SHARE", "transport"), ("PAYROLL", "income"), ("STREAMING CO", "subscriptions"),
             ("LANDLORD LLC", "rent"), ("GAS STATION", "fuel"), ("PHARMACY", "health"),
             ("BOOK SHOP", "shopping"), ("HARDWARE STORE", "shopping"), ("AIRLINE", "travel"),
             ("HOTEL", "travel"), ("GYM", "health"))
KINDS = ("CARD", "DEBIT", "CREDIT", "TRANSFER")
QUERY_PHRASES = ("dining purchases", "grocery spending", "rent payment", "salary deposit",
                 "transport costs", "subscriptions", "travel bookings", "health expenses")


def _day(ts: float) -> str:
    return time.strftime("%Y-%m-%d", time.gmtime(ts))


def transaction_rows(rng, user: str, n: int, now: float, days: int, start: int = 0) -> list[dict]:
    """``n`` transactions of ``user`` from a seeded generator: kind x merchant
    x amount x date, dates over the last ``days`` days, each half a day off
    any whole-day cutoff; the last three repeat earlier rows (a double
    charge: the same text and date). ``txn`` numbers them from ``start``."""
    rows: list[dict] = []
    for j in range(n):
        if j >= n - 3 and j >= 3:
            rows.append(dict(rows[int(rng.integers(0, n - 3))], txn=start + j))
            continue
        merchant, category = MERCHANTS[int(rng.integers(len(MERCHANTS)))]
        amount = round(float(rng.normal(0.0, 120.0)), 2) or 1.0
        date = now - (float(rng.integers(0, days)) + 0.5) * 86400.0
        text = f"{_day(date)} {KINDS[int(rng.integers(len(KINDS)))]} {merchant} {amount:+.2f} " \
               f"{category}"
        rows.append(dict(user=user, text=text, date=date, amount=amount, category=category,
                         txn=start + j))
    return rows


def plain_search(index, q, user: str, date_gte: float | None):
    """The float64 numpy search the index is held to, over its host copy of
    the normalized vectors and filters: every row of ``user`` (dated at or
    after ``date_gte``), best first, the lower row first among equal
    scores. Returns (rows, scores) of all the candidates."""
    import numpy as np

    n = index._count
    code = index._user_interner.get(user, -2)
    mask = index._alive[:n] & (index._user_codes[:n] == code)
    if date_gte is not None:
        mask &= index._dates[:n] >= date_gte
    rows = np.nonzero(mask)[0]
    q64 = np.asarray(q, np.float64)
    q64 = q64 / max(float(np.linalg.norm(q64)), 1e-9)
    scores = index._host_vectors[rows].astype(np.float64) @ q64
    order = np.lexsort((rows, -scores))
    return rows[order], scores[order]


def ranking_agrees(got: list, want_rows, want_scores, limit: int) -> dict:
    """``got`` (index rows) against the reference's first ``limit`` rows: the
    same count, the same row at every position whose reference score is more
    than SCORE_TIE from both neighbours (the candidates past the limit
    included), and an overlap of at least 0.99."""
    want = [int(r) for r in want_rows[:limit]]
    s = want_scores
    fixed = [i for i in range(len(want))
             if (i == 0 or s[i - 1] - s[i] > SCORE_TIE)
             and (i + 1 >= len(s) or s[i] - s[i + 1] > SCORE_TIE)]
    moved = [i for i in fixed if i >= len(got) or got[i] != want[i]]
    overlap = len(set(got) & set(want)) / len(want) if want else 1.0
    return dict(ok=len(got) == len(want) and not moved and overlap >= 0.99, n=len(want),
                fixed=len(fixed), moved=moved, overlap=overlap, exact=list(got) == want)


def plain_count(index, args: dict, now: float, default_limit: int = 10_000) -> int | None:
    """The rows a retrieval with these tool arguments returns by the plain
    search's count: the user's rows (in the ``time_period_days`` window),
    at most ``num_transactions`` (or the default). None where the count
    depends on the path the agent took (a limit of zero or less: the
    streamed adoption cuts the default's rows to it, the serial path does
    not)."""
    n = args.get("num_transactions")
    if isinstance(n, int) and n <= 0:
        return None
    days = args.get("time_period_days")
    date_gte = now - days * 86_400.0 if days else None
    rows, _s = plain_search(index, index._host_vectors[0], args["user_id"], date_gte)
    return min(int(n or default_limit), len(rows))


async def _ingest(torch, retriever, rows: list[dict]) -> dict:
    """Every row through ``upsert_transactions`` from worker threads,
    ``INGEST_CALL_TEXTS`` a call, the batcher bound to this loop: the
    threadsafe path, where concurrent calls coalesce into shared
    dispatches."""
    from finchat_tpu_torch.utils.metrics import METRICS

    retriever.batcher.bind_loop()
    calls = []
    for lo in range(0, len(rows), INGEST_CALL_TEXTS):
        part = rows[lo: lo + INGEST_CALL_TEXTS]
        if len({r["user"] for r in part}) != 1:
            fail("retrieval: an ingest call spans two users")
        calls.append((part[0]["user"], [r["text"] for r in part], [r["date"] for r in part],
                      [{"txn": r["txn"], "amount": r["amount"], "category": r["category"]}
                       for r in part]))
    m0 = METRICS.snapshot()
    t0 = time.perf_counter()
    await asyncio.gather(*(asyncio.to_thread(retriever.upsert_transactions, *c) for c in calls))
    _sync(torch)
    seconds = time.perf_counter() - t0
    dispatches = _metric_delta(METRICS, m0, "finchat_embed_batch_dispatches_total")
    requests = _metric_delta(METRICS, m0, "finchat_embed_requests_total")
    return dict(texts=len(rows), calls=len(calls), seconds=seconds,
                texts_per_s=len(rows) / seconds, dispatches=dispatches, requests=requests,
                dispatches_per_request=dispatches / max(requests, 1))


async def retrieval_phase(torch, dev, card: str) -> tuple[dict, dict]:
    """Embedding and retrieval at full width: ``bge-base-en`` (12 layers,
    768 wide), random weights from a seeded generator, framing texts with
    the 8B's ``ByteTokenizer`` as ``build_app`` does, bf16 and int8 (K8).

    Data: ``RETRIEVAL_TEXTS`` transactions of ``RETRIEVAL_USERS`` users
    (``transaction_rows``: the last 120 days, three double charges each)
    ingested through ``TransactionRetriever.upsert_transactions`` from
    worker threads with the microbatcher bound to this loop, by each
    encoder into its own index; then ``RETRIEVAL_ROWS - RETRIEVAL_TEXTS``
    seeded random unit vectors of ``RETRIEVAL_OTHER_USERS`` other users,
    dated over the last 730 days, through ``index.upsert`` into the bf16
    one: 262,144 rows, 805 MB of fp32 vectors on the card.

    Queries: one retrieval a corpus user, all 64 at once, through the bf16
    retriever's ``structured`` (the batcher coalesces their embeds): half
    with ``time_period_days=30`` (at the default 10,000 rows), half with
    ``num_transactions=10``. Each hit list must hold only the user's own
    rows and agree with ``plain_search`` (``ranking_agrees``), and so must
    ``query_points`` run serially on the same query vectors (the ones the
    batcher returned). The same retrievals then run one at a time through
    the int8 retriever's ``structured``, held to ``plain_search`` over the
    int8 index; the int8 encoder's rankings over the corpus on those query
    vectors must overlap the bf16 encoder's (top-10, near ties within 2e-3
    count). K8's launch counts are read in two windows of the main path,
    each set to 0 just before it: the int8 ingest (``sm90`` only, 48 a
    dispatch) and the int8 retrievals (the decode body only, 48 a query);
    the encoder-alone timing and the bf16 embeds of the comparison run
    outside both.

    Printed: ingest texts/s of both encoders, embed dispatches a request
    (ingest and queries), the first search after the bulk upsert (the
    whole matrix uploaded), the ``finchat_retrieval_{embed,search}_seconds``
    p50 (bucket edges) and means, the device time of one scoring call
    (``batch_mask`` + ``score_topk``) at B=32 over the collection against
    its bound, the host time of ``query_points_batch`` at B=32, and the
    phase's peak memory. Returns the stats and the bf16 retriever's parts
    for ``agent_turns``."""
    import numpy as np

    from finchat_tpu_torch.embed import (EMBED_PRESETS, DeviceVectorIndex, EmbeddingEncoder,
                                         EmbedMicrobatcher, QuerySpec, VectorPoint,
                                         init_bert_params)
    from finchat_tpu_torch.embed.index import _split_f64, batch_mask, score_topk
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.tools.retrieval import TransactionRetriever
    from finchat_tpu_torch.utils.metrics import METRICS

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = EMBED_PRESETS["bge-base-en"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = init_bert_params(cfg, gen, dev)
    tok = ByteTokenizer(vocab_size=128256)
    now = time.time()
    out: dict = dict(now=now)
    parts: dict = {}
    for name, quant in (("bf16", ""), ("int8", "int8")):
        encoder = EmbeddingEncoder(cfg, params, tok, quant=quant, device=dev)
        index = DeviceVectorIndex(dim=cfg.dim, device=dev)
        parts[name] = TransactionRetriever(encoder, index, now=lambda: now,
                                           batcher=EmbedMicrobatcher(encoder))
    del params
    rng = np.random.default_rng(19)
    per = RETRIEVAL_TEXTS // RETRIEVAL_USERS
    users = [f"user-{u:03d}" for u in range(RETRIEVAL_USERS)]
    corpus = [row for u, user in enumerate(users)
              for row in transaction_rows(rng, user, per, now, 120, start=u * per)]
    per_call = 4 * cfg.n_layers  # the int8 matmuls of one encoder call
    for name in ("bf16", "int8"):
        if name == "int8":
            reset_launches()  # the int8 ingest's window: only its own launches
        out[f"ingest_{name}"] = ing = await _ingest(torch, parts[name], corpus)
        log(f"  retrieval ingest ({name}, {card}): {ing['texts']} texts in {ing['calls']} "
            f"upsert calls, {ing['seconds']:.2f} s, {ing['texts_per_s']:.0f} texts/s; "
            f"{ing['dispatches']:.0f} embed dispatches for {ing['requests']:.0f} requests "
            f"({ing['dispatches_per_request']:.3f} a request)")
    ingest_launches = dict(LAUNCHES)
    bf16, int8 = parts["bf16"], parts["int8"]
    # every dispatch of the int8 ingest holds whole requests of
    # INGEST_CALL_TEXTS texts in a bucket of 32 tokens or more (M >= 256):
    # each of its matmuls goes to the Hopper kernel
    want = dict(sm90=per_call * int(out["ingest_int8"]["dispatches"]), dec=0, v2=0)
    got = dict(sm90=ingest_launches["quant_matmul_int8_sm90"],
               dec=ingest_launches["quant_matmul_int8_decode_sm90"],
               v2=ingest_launches["quant_matmul_int8"])
    log(f"  retrieval int8 ingest K8 launches: {got} (want {want})")
    if got != want or want["sm90"] == 0:
        fail(f"retrieval: the int8 ingest's K8 launches {got}, want {want}: {per_call} Hopper "
             f"launches a dispatch, none of the decode body or v2")
    # one dispatch's work without the batcher and the threads: 32 corpus
    # texts (a 64-token bucket) through each encoder, host clock to numpy
    texts32 = [r["text"] for r in corpus[:32]]
    alone = {}
    for name, r in parts.items():
        r.encoder.embed_batch(texts32)
        t0 = time.perf_counter()
        for _ in range(5):
            r.encoder.embed_batch(texts32)
        alone[name] = (time.perf_counter() - t0) / 5 * 1e3
    out["encoder_alone_ms"] = alone
    log(f"  retrieval encoder alone ({card}): 32 texts in a 64-token bucket, "
        + ", ".join(f"{name} {ms:.2f} ms ({32e3 / ms:.0f} texts/s)" for name, ms in alone.items()))
    index = bf16.index
    # the rest of the collection: seeded random unit vectors of other users
    n_other = RETRIEVAL_ROWS - RETRIEVAL_TEXTS
    rng = np.random.default_rng(20)
    vectors = rng.standard_normal((n_other, cfg.dim), dtype=np.float32)
    dates = now - rng.uniform(0.0, 730.0, n_other) * 86400.0
    owners = rng.integers(0, RETRIEVAL_OTHER_USERS, n_other)
    t0 = time.perf_counter()
    index.upsert([VectorPoint(id=f"other-{i}", vector=vectors[i],
                              payload={"page_content": f"row {i}",
                                       "metadata": {"user_id": f"other-{owners[i]:04d}",
                                                    "date": float(dates[i])}})
                  for i in range(n_other)])
    out["upsert_random_s"] = time.perf_counter() - t0
    if index._count != RETRIEVAL_ROWS or index._capacity != RETRIEVAL_ROWS:
        fail(f"retrieval: the index holds {index._count} rows at capacity {index._capacity}")
    # the first search after the growth uploads the whole matrix; the
    # retrievals below then search the resident one
    t0 = time.perf_counter()
    index.query_points_batch([QuerySpec(np.ones(cfg.dim, np.float32), limit=1)])
    out["first_search_s"] = time.perf_counter() - t0
    txn_row = {p.metadata["txn"]: r for r, p in enumerate(index._points[:RETRIEVAL_TEXTS])}
    int8_row = {p.metadata["txn"]: r for r, p in enumerate(int8.index._points)}

    def recording(retriever, used: dict):
        """Wrap the retriever's ``batcher.embed_one`` to keep the query
        vectors it returns, so the hits can be held to the plain search."""
        embed_one = retriever.batcher.embed_one

        async def wrapped(text):
            used[text] = await embed_one(text)
            return used[text]

        retriever.batcher.embed_one = wrapped

    def check_hits(retriever, rows: dict, a: dict, got: list, q, serial: bool) -> dict:
        """One retrieval's hits: nonempty, the user's own, and in the float64
        plain search's order (``ranking_agrees``); ``serial`` also holds the
        serial plane's ``query_points`` on the same vector to it."""
        date_gte = now - a["time_period_days"] * 86_400.0 if "time_period_days" in a else None
        limit = a.get("num_transactions") or retriever.default_limit
        want_rows, want_s = plain_search(retriever.index, q, a["user_id"], date_gte)
        if not got or any(r["user_id"] != a["user_id"] for r in got):
            fail(f"retrieval: {a} returned {len(got)} rows, or another user's: "
                 f"{[r['user_id'] for r in got][:5]}")
        batched = ranking_agrees([rows[r["txn"]] for r in got], want_rows, want_s, limit)
        one = dict(n=batched["n"], fixed=batched["fixed"], overlap=batched["overlap"],
                   exact=batched["exact"])
        if serial:
            serial_hits = retriever.index.query_points(q, limit=limit, user_id=a["user_id"],
                                                       date_gte=date_gte)
            agree = ranking_agrees([rows[p.metadata["txn"]] for p in serial_hits], want_rows,
                                   want_s, limit)
            one.update(serial_exact=agree["exact"], planes_equal=[
                p.metadata["txn"] for p in serial_hits] == [r["txn"] for r in got])
        else:
            agree = batched
        if not (batched["ok"] and agree["ok"]):
            fail(f"retrieval: {a}: the hits disagree with the float64 plain search: batched "
                 f"{batched}, serial {agree}")
        return one

    # 64 retrievals at once through the bf16 retriever
    used: dict = {}
    recording(bf16, used)
    args = []
    for u, user in enumerate(users):
        a = {"user_id": user, "search_query": f"{QUERY_PHRASES[u % len(QUERY_PHRASES)]} #{u}"}
        a.update({"time_period_days": 30} if u < RETRIEVAL_USERS // 2 else {"num_transactions": 10})
        args.append(a)
    m0 = METRICS.snapshot()
    t0 = time.perf_counter()
    hits = await asyncio.gather(*(bf16.structured(a) for a in args))
    out["queries_wall_s"] = time.perf_counter() - t0
    del bf16.batcher.embed_one
    out["query_dispatches"] = _metric_delta(METRICS, m0, "finchat_embed_batch_dispatches_total")
    embed_s = _seconds(METRICS, m0, "finchat_retrieval_embed_seconds")
    search_s = _seconds(METRICS, m0, "finchat_retrieval_search_seconds")
    out["retrieval_seconds"] = dict(
        embed_p50=METRICS.quantile("finchat_retrieval_embed_seconds", 0.5),
        search_p50=METRICS.quantile("finchat_retrieval_search_seconds", 0.5),
        embed_mean=embed_s["mean_s"], search_mean=search_s["mean_s"], n=embed_s["n"])
    checks = [check_hits(bf16, txn_row, a, got, used[a["search_query"]], True)
              for a, got in zip(args, hits)]
    out["checks"] = dict(
        queries=len(checks), rows=sum(c["n"] for c in checks),
        fixed_positions=sum(c["fixed"] for c in checks),
        min_overlap=min(c["overlap"] for c in checks),
        exact_lists=sum(c["exact"] for c in checks),
        serial_exact_lists=sum(c["serial_exact"] for c in checks),
        planes_equal=sum(c["planes_equal"] for c in checks))
    log(f"  retrieval queries ({card}): {len(args)} at once in {out['queries_wall_s']:.3f} s, "
        f"{out['query_dispatches']:.0f} embed dispatches; finchat_retrieval_embed_seconds p50 "
        f"{out['retrieval_seconds']['embed_p50']:.4f} s (mean "
        f"{out['retrieval_seconds']['embed_mean']:.4f}), finchat_retrieval_search_seconds p50 "
        f"{out['retrieval_seconds']['search_p50']:.4f} s (mean "
        f"{out['retrieval_seconds']['search_mean']:.4f}); against the float64 plain search: "
        + json.dumps(out["checks"]))
    # the same 64 retrievals through the int8 retriever, one at a time: each
    # a lone query through the batcher (one text in a 32-token bucket, M=32),
    # so each of its matmuls goes to the decode body; a window of their own
    used8: dict = {}
    recording(int8, used8)
    m0 = METRICS.snapshot()
    reset_launches()
    t0 = time.perf_counter()
    hits8 = [await int8.structured(a) for a in args]
    out["int8_queries_wall_s"] = time.perf_counter() - t0
    query_launches = dict(LAUNCHES)
    del int8.batcher.embed_one
    dispatches8 = int(_metric_delta(METRICS, m0, "finchat_embed_batch_dispatches_total"))
    checks8 = [check_hits(int8, int8_row, a, got, used8[a["search_query"]], False)
               for a, got in zip(args, hits8)]
    out["int8_checks"] = dict(queries=len(checks8), dispatches=dispatches8,
                              min_overlap=min(c["overlap"] for c in checks8),
                              exact_lists=sum(c["exact"] for c in checks8))
    want = dict(sm90=0, dec=per_call * len(args), v2=0)
    got = dict(sm90=query_launches["quant_matmul_int8_sm90"],
               dec=query_launches["quant_matmul_int8_decode_sm90"],
               v2=query_launches["quant_matmul_int8"])
    log(f"  retrieval int8 queries ({card}): {len(args)} one at a time in "
        f"{out['int8_queries_wall_s']:.3f} s, {dispatches8} embed dispatches; against the float64 "
        f"plain search over the int8 index: {json.dumps(out['int8_checks'])}; K8 launches: {got} "
        f"(want {want})")
    if got != want or dispatches8 != len(args):
        fail(f"retrieval: the int8 queries' K8 launches {got} in {dispatches8} dispatches, want "
             f"{want} in {len(args)}: {per_call} decode-body launches a lone query")
    out["launches"] = dict(ingest=ingest_launches, query=query_launches)
    # the int8 encoder against the bf16 one, on the query vectors the int8
    # retrievals used and each bf16 query embedded alone
    texts = [a["search_query"] for a in args]
    order = sorted(txn_row)
    e_bf16 = index._host_vectors[[txn_row[t] for t in order]]
    e_int8 = int8.index._host_vectors[[int8_row[t] for t in order]]
    q_bf16 = np.stack([bf16.encoder.embed_query(t) for t in texts])
    q_int8 = np.stack([used8[t] for t in texts])
    overlaps, strict = [], []
    for j in range(len(texts)):
        s = e_bf16 @ q_bf16[j]
        picked = np.argsort(-(e_int8 @ q_int8[j]), kind="stable")[:RANK_K]
        kth = np.sort(s)[-RANK_K]
        overlaps.append(float(np.mean(s[picked] >= kth - RANK_EPS)))
        strict.append(float(np.mean(s[picked] >= kth)))
    cos = (e_bf16 * e_int8).sum(-1)
    out["int8_vs_bf16"] = ranks = dict(top10_overlap=float(np.mean(overlaps)),
                                       top10_overlap_no_eps=float(np.mean(strict)),
                                       min_corpus_cosine=float(cos.min()))
    log(f"  retrieval int8 vs bf16 encoder: top-10 overlap {ranks['top10_overlap']:.4f}"
        f" (near ties within {RANK_EPS}; {ranks['top10_overlap_no_eps']:.4f} "
        f"without), corpus cosine >= {ranks['min_corpus_cosine']:.5f}")
    if ranks["top10_overlap"] < 0.99:
        fail(f"retrieval: the int8 encoder's rankings overlap the bf16 one's "
             f"{ranks['top10_overlap']:.4f} < 0.99")
    # one scoring call at B=32 over the collection, on the card
    dv = index._device
    B = min(32, len(texts))
    q32 = torch.from_numpy(np.stack([q_bf16[j] / np.linalg.norm(q_bf16[j]) for j in range(B)])
                           .astype(np.float32)).to(dev)
    codes = torch.tensor([index._user_interner[a["user_id"]] for a in args[:B]],
                         dtype=torch.int32, device=dev)
    hi, lo = _split_f64(np.asarray([now - 30 * 86_400.0 if j % 2 else -np.inf
                                    for j in range(B)]))
    hi, lo = torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)

    def scoring():
        return score_topk(dv["vectors"], q32, batch_mask(dv["alive"], dv["user_codes"],
                                                         dv["dates_hi"], dv["dates_lo"],
                                                         codes, hi, lo), RANK_K)

    N = RETRIEVAL_ROWS
    moved = N * cfg.dim * 4 + N * (1 + 4 + 4 + 4) + B * cfg.dim * 4 + B * RANK_K * 12
    flops = 2.0 * B * N * cfg.dim
    bound = max(moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
    score_ms = time_ms(torch, scoring)
    specs = [QuerySpec(q_bf16[j], limit=RANK_K, user_id=args[j]["user_id"]) for j in range(B)]
    index.query_points_batch(specs)
    t0 = time.perf_counter()
    for _ in range(5):
        index.query_points_batch(specs)
    batch_host_ms = (time.perf_counter() - t0) / 5 * 1e3
    out["scoring"] = dict(B=B, rows=N, k=RANK_K, device_ms=score_ms, bound_ms=bound,
                          bound_by="bytes" if moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS_PER_S
                          else "operations", vectors_bound_ms=N * cfg.dim * 4 / HBM_BYTES_PER_S
                          * 1e3, query_points_batch_host_ms=batch_host_ms)
    out["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    out["held_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
    log(f"  retrieval scoring ({card}): B={B} over {N} rows, k={RANK_K}: {score_ms:.4f} ms on the "
        f"card (mask + product + top-k), bound {bound:.4f} ms ({out['scoring']['bound_by']}; the "
        f"vectors alone {out['scoring']['vectors_bound_ms']:.4f}); query_points_batch "
        f"{batch_host_ms:.3f} ms of host time; peak {out['peak_gb']:.2f} GB, held "
        f"{out['held_gb']:.2f} GB; random rows upserted in {out['upsert_random_s']:.2f} s, the "
        f"first search after them (the whole matrix uploaded) {out['first_search_s']:.3f} s")
    del int8, parts, e_int8, q_int8
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  retrieval: the phase took {out['phase_s']:.1f} s")
    return out, dict(retriever=bf16, users=users, now=now)


APP_CONVS = 4
APP_TURN2 = 2
APP_WAIT_S = 300.0
APP_TXNS = 12  # transactions ingested a conversation's user before turn 1


def _app_context(i: int) -> dict:
    """A conversation's stored context document (``render_context`` gives
    the prompt's context block): a few accounts and expenses, so the
    context runs past the head's last page and a second turn has whole
    pages of its own to resume."""
    return {
        "user_id": f"user-app-{i}", "name": f"Member {i}", "income": 5200 + 100 * i,
        "savings_goal": 600 + 25 * i,
        "accounts": [{"official_name": f"Everyday Checking {k}",
                      "balances": {"current": 1234.5 + 10 * k, "iso_currency_code": "USD"}}
                     for k in range(4)],
        "additional_monthly_expenses": [
            {"name": name, "amount": amount, "description": desc}
            for name, amount, desc in (("Rent", 1850, "downtown apartment"), ("Gym", 40, ""),
                                       ("Car loan", 412, "9,800 at 6.9% APR"),
                                       ("Streaming", 16, "two services"))],
    }


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, method: str, path: str, body: dict | None = None,
          headers: dict | None = None) -> tuple[int, str, str]:
    """One request over a real socket with the stdlib (the card's machine
    has no HTTP client package): (status, content type, body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=APP_WAIT_S)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read().decode()
    finally:
        conn.close()


def _prometheus_families(text: str) -> set:
    """The families of a Prometheus text exposition, each line checked: a
    ``# TYPE`` / ``# exemplar`` comment or a ``name{labels} value`` sample
    with a float value. Fails on a line that is neither."""
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')
    families = set()
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# exemplar "):
            continue
        if line.startswith("# TYPE "):
            families.add(line.split(" ")[2])
            continue
        m = sample.match(line)
        if m is None:
            fail(f"app turns: /metrics line is not Prometheus text: {line!r}")
        float(m.group(3))
    return families


def _check_chunks(what: str, raw: list, payloads: dict) -> dict:
    """Every outbound record of ``ai_response`` parses and follows the
    reference protocol: response chunks (``last_message`` false, ``error``
    false, sender ``AIMessage``, every inbound field passed through), then
    one ``complete`` marker carrying the original user text; an error chunk
    (no ``type``) fails the phase. Returns message_id -> the concatenated
    response text."""
    texts: dict = {}
    completes: dict = {}
    for value in raw:
        chunk = json.loads(value)
        mid = chunk.get("message_id")
        if mid not in payloads:
            fail(f"app turns ({what}): an outbound record of no inbound message: {chunk}")
        inbound = payloads[mid]
        if "type" not in chunk or chunk.get("error") is not False:
            fail(f"app turns ({what}): an error chunk for {mid}: {chunk}")
        if completes.get(mid):
            fail(f"app turns ({what}): a record after {mid}'s complete marker: {chunk}")
        passthrough = all(chunk.get(k) == v for k, v in inbound.items() if k != "message")
        if chunk["type"] == "response_chunk":
            ok = (chunk["last_message"] is False and chunk["sender"] == "AIMessage"
                  and isinstance(chunk["message"], str) and passthrough)
            texts[mid] = texts.get(mid, "") + chunk["message"]
        elif chunk["type"] == "complete":
            ok = (chunk["last_message"] is True and chunk["sender"] == "AIMessage"
                  and chunk["message"] == inbound["message"] and passthrough)
            completes[mid] = True
        else:
            ok = chunk["type"] == "plot" and chunk["message"].startswith("data:image/png")
        if not ok:
            fail(f"app turns ({what}): a record breaks the chunk protocol: {chunk}")
    missing = [mid for mid in payloads if mid not in completes]
    if missing:
        fail(f"app turns ({what}): no complete marker for {missing}")
    return {mid: texts.get(mid, "") for mid in payloads}


async def app_turns(torch, dev, card: str) -> dict:
    """Penny turns through the port's serving app at ``llama3-8b``'s full
    width, bf16: ``build_app`` itself builds the model (random weights from
    ``model.seed``, its ``ByteTokenizer`` as wide as the logits rows), the
    engine at ``EngineConfig()``'s defaults, warmed up, and registers both
    prompt heads; an ``InMemoryStore`` holds four conversations, a
    ``KafkaClient`` rides an ``InMemoryBroker``, and with no ``retriever=``
    ``build_app`` builds its own: the ``bge-base-en`` encoder (random
    weights), the on-device index snapshotting to ``vector.persist_path``
    (a temporary directory), the microbatcher and ``TransactionRetriever``.
    Sampling is greedy (``engine.temperature``
    0, the agent's decision greedy under its grammar) so every stream can be
    teacher-forced; ``engine.max_new_tokens`` is 64, ``kafka.
    commit_after_process`` on, the session disk tier, journal and flight
    recorder in a temporary directory.

    Driven through the consume loop (``app.start(serve_http=True)``): first
    ``APP_TXNS`` transactions of each conversation's user, three users'
    through ``POST /transactions`` and one batch on the
    ``transaction_upsert`` topic; then four
    user messages produced at once, then a second turn of two
    conversations (resumed through the session cache), then one answered
    message redelivered (deduped: nothing produced, the skip counter up by
    one). Over HTTP from a worker thread: ``/health``, one
    ``/chat/stream`` turn (the reference's SSE event order), ``/metrics``
    (Prometheus text with ``finchat_ttft_seconds`` and the Kafka families)
    and ``/debug/trace/<message_id>`` (the message's ingress event and
    first token). Last ``drain_and_stop()``: no slot or page left beyond the
    heads, the session entries on disk, the journal holding exactly the
    answered ids, and the index's snapshot on disk: ``DeviceVectorIndex.load``
    of it gives the live index's hits. Every turn whose decision retrieved
    must report the plain search's count for its arguments
    (``plain_count``). Launch counts are set to 0 after the build and read
    before the drain: every bf16 serving kernel launched, under the serve's
    launch rules, and no older body."""
    import shutil
    import tempfile

    import finchat_tpu_torch.engine.engine as engine_mod
    import finchat_tpu_torch.serve.app as app_mod
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.io.journal import AnsweredJournal
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    import numpy as np

    from finchat_tpu_torch.embed.encoder import EMBED_PRESETS
    from finchat_tpu_torch.embed.index import DeviceVectorIndex
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.tools.retrieval import TransactionRetriever
    from finchat_tpu_torch.utils.config import (AI_RESPONSE_TOPIC, TRANSACTION_UPSERT_TOPIC,
                                                USER_MESSAGE_TOPIC, KafkaConfig, load_config)
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    t_phase = time.perf_counter()
    spec = PLANES["bf16"]
    gc.collect()  # the earlier phases' engines and trees are gone before this one
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="finchat-app-")
    port = _free_port()
    cfg = load_config(overrides={
        "model.preset": "llama3-8b", "engine.max_new_tokens": AGENT_NEW,
        "engine.temperature": 0.0, "kafka.commit_after_process": True,
        "engine.session_cache_disk_path": f"{tmp}/sessions", "journal.path": f"{tmp}/journal",
        "tracing.flight_dir": f"{tmp}/flight", "serve.host": "127.0.0.1", "serve.port": port,
        "embed.preset": "bge-base-en", "vector.persist_path": f"{tmp}/vectors"})
    store = InMemoryStore()
    t_hist = int(time.time()) - 600
    for i in range(APP_CONVS):
        store.upsert_context(f"app-{i}", _app_context(i))
        store.add_user_message(f"app-{i}", MESSAGES[i], f"user-app-{i}", timestamp=t_hist)
    broker = InMemoryBroker()
    # the build's parts, timed where build_app calls them
    timed: dict = {}
    load, warmup = app_mod._load_model_artifacts, engine_mod.InferenceEngine.warmup

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        out = load(*a, **k)
        torch.cuda.synchronize()
        timed["weights_s"] = time.perf_counter() - t0
        timed["weights_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
        return out

    def timed_warmup(self):
        t0 = time.perf_counter()
        out = warmup(self)
        timed["warmup_s"] = time.perf_counter() - t0
        return out

    app_mod._load_model_artifacts = timed_load
    engine_mod.InferenceEngine.warmup = timed_warmup
    t0 = time.perf_counter()
    try:
        app = app_mod.build_app(cfg, store=store, kafka=KafkaClient(cfg.kafka, broker=broker),
                                device=dev)
    finally:
        app_mod._load_model_artifacts = load
        engine_mod.InferenceEngine.warmup = warmup
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    sched = app.scheduler
    engine = sched.engine
    config = engine.config
    tok = app.agent.tool_generator.tokenizer
    head_pages = sum(len(e.pages) for e in sched._prefixes)
    log(f"  app build ({card}): build_app {build_s:.1f} s — weights {timed['weights_s']:.1f} s "
        f"({timed['weights_gb']:.2f} GB), warmup {timed['warmup_s']:.1f} s "
        f"({engine.compiled_variants} step variants); peak {build_peak:.2f} GB above the "
        f"{base / 1e9:.2f} GB held before; tokenizer {tok.vocab_size} ids wide; prompt heads "
        f"registered by the app: {len(app._registered_heads)} ({head_pages} pages)")
    if tok.vocab_size != config.vocab_size or len(app._registered_heads) != 2 or not head_pages:
        fail("app turns: build_app did not give a vocab-wide tokenizer and two registered heads")
    retriever = app.retriever
    if not (isinstance(retriever, TransactionRetriever) and app.agent.retriever is retriever
            and retriever.index.device == dev and retriever.batcher is not None
            and retriever.encoder.config == EMBED_PRESETS["bge-base-en"]):
        fail(f"app turns: build_app's own retriever is not the on-device one: {retriever}")
    # each retrieving turn: (user, tool call, the count it reported)
    retrieved: dict = {}
    retrieve_node = app.agent._retrieve_data_node

    async def recording_node(state):
        call = state.tool_calls[0] if state.tool_calls else None
        state = await retrieve_node(state)
        if call is not None:
            retrieved[state.trace_id] = (state.user_id, call.name, dict(call.args),
                                         len(state.retrieved_transactions))
        return state

    app.agent._retrieve_data_node = recording_node
    # the decision greedy under its grammar, as the earlier phases decode it
    app.agent.tool_sampling = SamplingParams(temperature=0.0, max_new_tokens=DECISION_NEW,
                                             grammar="tool_call")
    handles: list = []
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    sched.submit = recording_submit
    counts = _Counts(engine)
    watcher = KafkaClient(KafkaConfig(), broker=broker)
    watcher.setup_consumer(topics=[AI_RESPONSE_TOPIC])  # latest: joins before any produce
    producer = KafkaClient(KafkaConfig(), broker=broker)
    outbound: list = []

    def drain_watcher() -> int:
        n = 0
        while (m := watcher.poll_message()) is not None:
            outbound.append(m.value())
            n += 1
        return n

    payloads: dict = {}
    produced_at: dict = {}

    def produce(conv: int, mid: str, text: str) -> None:
        payload = {"message": text, "conversation_id": f"app-{conv}",
                   "user_id": f"user-app-{conv}", "message_id": mid}
        payloads[mid] = payload
        produced_at[mid] = time.time()
        producer.produce_message(USER_MESSAGE_TOPIC, payload["conversation_id"], payload)

    def completes() -> int:
        drain_watcher()
        return sum(json.loads(v).get("type") == "complete" for v in outbound)

    m0 = METRICS.snapshot()
    reset_launches()
    TRACER.clear()
    wall_offset = time.time() - time.perf_counter()
    out: dict = {}
    try:
        await app.start(serve_http=True)
        # the users' transactions: three over HTTP, one batch on the topic
        t_ingest = time.perf_counter()
        rng = np.random.default_rng(21)
        txns = {i: transaction_rows(rng, f"user-app-{i}", APP_TXNS, time.time(), 60)
                for i in range(APP_CONVS)}

        def body(i: int) -> dict:
            return {"user_id": f"user-app-{i}", "transactions": [
                {"text": r["text"], "date": r["date"], "amount": r["amount"],
                 "category": r["category"]} for r in txns[i]]}

        for i in range(APP_CONVS - 1):
            answer = await asyncio.to_thread(_http, port, "POST", "/transactions", body(i))
            if answer[0] != 200 or json.loads(answer[2]) != {"upserted": APP_TXNS}:
                fail(f"app turns: POST /transactions answered {answer}")
        producer.produce_message(TRANSACTION_UPSERT_TOPIC, f"user-app-{APP_CONVS - 1}",
                                 body(APP_CONVS - 1))
        await _wait_for(lambda: len(retriever.index) == APP_CONVS * APP_TXNS,
                        "app turns: the transaction_upsert batch was not ingested", APP_WAIT_S)
        out["ingest_s"] = time.perf_counter() - t_ingest
        log(f"  app ingest ({card}): {APP_CONVS * APP_TXNS} transactions of {APP_CONVS} users, "
            f"{APP_CONVS - 1} over POST /transactions and one topic batch, in "
            f"{out['ingest_s']:.2f} s")
        # turn 1: four conversations at once
        t_turns = time.perf_counter()
        for i in range(APP_CONVS):
            produce(i, f"app-m{i}", MESSAGES[i])
        await _wait_for(lambda: completes() >= APP_CONVS,
                        "app turns: turn 1 did not complete", APP_WAIT_S)
        hits1 = _metric_delta(METRICS, m0, "finchat_prefix_hits_total")
        # turn 2 of two conversations: the history now holds turn 1's answer
        s0 = METRICS.snapshot()
        for i in range(APP_TURN2):
            store.add_user_message(f"app-{i}", MESSAGES[4 + i], f"user-app-{i}")
            produce(i, f"app-m{i}-t2", MESSAGES[4 + i])
        await _wait_for(lambda: completes() >= APP_CONVS + APP_TURN2,
                        "app turns: turn 2 did not complete", APP_WAIT_S)
        turns_s = time.perf_counter() - t_turns
        session_hits = _metric_delta(METRICS, s0, "finchat_session_cache_hits_total")
        await _wait_for(lambda: not app._inflight, "app turns: a message stayed in flight")
        # a redelivery of an answered message
        n_before = len(outbound)
        d0 = METRICS.get("finchat_kafka_dedupe_skips_total")
        producer.produce_message(USER_MESSAGE_TOPIC, "app-0", payloads["app-m0"])
        await _wait_for(lambda: METRICS.get("finchat_kafka_dedupe_skips_total") > d0,
                        "app turns: the redelivered message was not deduped")
        await _wait_for(lambda: not app._inflight, "app turns: the redelivery stayed in flight")
        drain_watcher()
        dedupe = dict(skips=METRICS.get("finchat_kafka_dedupe_skips_total") - d0,
                      new_records=len(outbound) - n_before)
        if dedupe != dict(skips=1, new_records=0):
            fail(f"app turns: the redelivery was answered again or not counted: {dedupe}")
        # HTTP, from a worker thread: the server shares this loop
        http_out: dict = {}
        http_out["health"] = await asyncio.to_thread(_http, port, "GET", "/health")
        store.add_user_message("app-3", MESSAGES[6], "user-app-3")
        status, ctype, text = await asyncio.to_thread(
            _http, port, "POST", "/chat/stream",
            {"conversation_id": "app-3", "message": MESSAGES[6], "user_id": "user-app-3"},
            {"x-trace-id": "app-http-1"})
        sse = [json.loads(line[6:]) for line in text.split("\n") if line.startswith("data: ")]
        http_out["stream"] = (status, ctype, len(sse))
        if (status, ctype) != (200, "text/event-stream"):
            fail(f"app turns: /chat/stream answered {status} {ctype}: {text[:500]}")
        retrieved_http, _count = check_turn_protocol("bf16", "app /chat/stream", sse)
        status, ctype, metrics_text = await asyncio.to_thread(_http, port, "GET", "/metrics")
        families = _prometheus_families(metrics_text)
        want_families = {"finchat_ttft_seconds", "finchat_kafka_produced_total",
                         "finchat_kafka_commits_total", "finchat_kafka_dedupe_skips_total",
                         "finchat_durability_journal_appends_total"}
        http_out["metrics"] = (status, ctype, len(families))
        if status != 200 or not want_families <= families:
            fail(f"app turns: /metrics {status} lacks {sorted(want_families - families)}")
        status, ctype, trace_text = await asyncio.to_thread(_http, port, "GET",
                                                            "/debug/trace/app-m0")
        names = [e["name"] for e in json.loads(trace_text)["traceEvents"]] if status == 200 else []
        http_out["trace"] = (status, len(names))
        if "ingress" not in names or "first_token" not in names:
            fail(f"app turns: /debug/trace/app-m0 ({status}) lacks ingress or first_token: "
                 f"{sorted(set(names))}")
        if http_out["health"] != (200, "application/json", '{"status": "healthy"}'):
            fail(f"app turns: /health answered {http_out['health']}")
        log(f"  app HTTP ({card}): /health ok; /chat/stream {len(sse)} events in the reference "
            f"order (retrieved {retrieved_http}); /metrics {len(families)} families, "
            f"Prometheus text; /debug/trace/app-m0 {len(names)} events with ingress and "
            "first_token")
        # the window's launches, read before the drain
        launches = dict(LAUNCHES)
        decode_steps = _metric_delta(METRICS, m0, "finchat_decode_dispatches_total")
        rounds = _metric_delta(METRICS, m0, "finchat_mixed_dispatches_total")
        missing = [k for k in spec["kernels"] if launches[k] == 0]
        if missing:
            fail(f"app turns: kernels not launched on the app's path: {missing}")
        check_window("bf16", "app turns", spec, config, launches, counts, decode_steps, rounds)
        out["launches"] = {k: v for k, v in launches.items() if v}
        # every retrieving turn's count against the plain search
        now = time.time()
        counts_vs_plain = []
        for mid, (user, name, call_args, count) in sorted(retrieved.items()):
            want = plain_count(retriever.index, {**call_args, "user_id": user}, now)
            counts_vs_plain.append(dict(message_id=mid, tool=name, args=call_args, count=count,
                                        plain=want))
            if want is not None and count != want:
                fail(f"app turns: {mid} ({name} {call_args}) reported {count} rows, the plain "
                     f"search {want}")
        out["retrievals"] = counts_vs_plain
        log(f"  app retrievals: {len(counts_vs_plain)} turns retrieved; " + json.dumps(
            [(r["message_id"], r["tool"], r["count"], r["plain"]) for r in counts_vs_plain]))
        # the live index's hits for each user, to hold the snapshot against
        probe = np.linspace(-1.0, 1.0, retriever.encoder.dim, dtype=np.float32)
        live = {i: [p.id for p in retriever.index.query_points(
            probe, limit=10, user_id=f"user-app-{i}")] for i in range(APP_CONVS)}
        # the drain
        sp0 = METRICS.get("finchat_durability_spills_total")
        drain_t0 = time.perf_counter()
        await app.drain_and_stop()
        drain_s = time.perf_counter() - drain_t0
        drain_watcher()
    finally:
        sched.submit = submit
        counts.close()
        watcher.close()
    entries = list(sched.session_cache._entries)
    on_disk = [k for k in entries if k in sched.session_cache.disk]
    leak = dict(used=sched.allocator.used_count, heads=head_pages,
                free_slots=len(sched.free_slots), max_seqs=cfg.engine.max_seqs,
                live=len(sched.decoding) + len(sched.prefilling) + len(sched.pending))
    log(f"  app drain ({card}): {drain_s:.2f} s; pages {leak['used']} (the heads' "
        f"{head_pages}), free slots {leak['free_slots']}/{leak['max_seqs']}, live "
        f"{leak['live']}; session entries {len(entries)} in RAM, {len(on_disk)} on disk, spills "
        f"+{METRICS.get('finchat_durability_spills_total') - sp0:.0f}")
    if leak["used"] != head_pages or leak["free_slots"] != leak["max_seqs"] or leak["live"]:
        fail(f"app turns: the drain left work, a slot or a page: {leak}")
    if not entries or len(on_disk) != len(entries):
        fail(f"app turns: session entries not all on disk after the drain: {entries} / {on_disk}")
    sched.retire_prefixes()
    if sched.allocator.used_count != 0:
        fail(f"app turns: {sched.allocator.used_count} pages after retire_prefixes")
    journal = AnsweredJournal(cfg.journal.path, num_partitions=broker.num_partitions)
    journaled = sorted(journal.replay(compact=False))
    journal.close()
    if journaled != sorted(payloads):
        fail(f"app turns: the journal holds {journaled}, the answered ids are {sorted(payloads)}")
    snap = cfg.vector.snapshot_base()
    if not (Path(snap + ".npz").exists() and Path(snap + ".jsonl").exists()):
        fail(f"app turns: no vector snapshot at {snap} after the drain")
    restored = DeviceVectorIndex.load(snap, dim=retriever.encoder.dim, device=dev)
    again = {i: [p.id for p in restored.query_points(probe, limit=10, user_id=f"user-app-{i}")]
             for i in range(APP_CONVS)}
    if len(restored) != APP_CONVS * APP_TXNS or again != live or \
            any(len(v) != 10 for v in live.values()):
        fail(f"app turns: the snapshot's hits {again} are not the live index's {live}")
    del restored
    log(f"  app snapshot: {APP_CONVS * APP_TXNS} rows at {Path(snap).name}.{{npz,jsonl}}; loaded "
        "back, the same hits for every user")
    # the chunks, the store, the handles
    texts = _check_chunks("Kafka", outbound, payloads)
    ai_by_conv: dict = {}
    for m in store._messages:
        if m["sender"] == "AIMessage":
            ai_by_conv.setdefault(m["conversation_id"], []).append(m["message"])
    for i in range(APP_CONVS):
        # the Kafka turns persist their answers; the SSE path does not
        mids = [f"app-m{i}"] + ([f"app-m{i}-t2"] if i < APP_TURN2 else [])
        want = [texts[mid] for mid in mids]
        got = ai_by_conv.get(f"app-{i}", [])
        if got != want:
            fail(f"app turns: app-{i}'s stored answers {got} are not its chunks {want}")
    vocab = await app.agent.tool_generator._grammar_vocabs["tool_call"]
    if len(vocab.token_strs) != config.vocab_size:
        fail(f"app turns: the grammar is {len(vocab.token_strs)} ids wide")
    checks, rows = [], []
    params = engine.params
    for h in handles:
        if not (h.finished and h.generated > 0):
            continue
        decision = h.conversation_id.endswith("#tool")
        _stream_ended("bf16", "app turns", h, tok.eos_id)
        checks.append(teacher_forced_check(torch, params, config, h, "",
                                           vocab=vocab if decision else None))
    for mid in list(payloads) + ["app-http-1"]:
        mine = [h for h in handles if h.trace_id == mid]
        response = [h for h in mine if h.conversation_id.endswith("#resp")]
        marks = [ev for ev in TRACER.snapshot() if ev[1] == mid]
        ingress = next((ev[0] for ev in marks if ev[2] == "ingress"), None)
        start = next((ev[0] for ev in marks if ev[2] == "decide_start"), None)
        if ingress is None or start is None or not response or \
                response[-1].first_token_at is None:
            fail(f"app turns: {mid} has no ingress, decide_start or response first token")
        rows.append(dict(
            message_id=mid, ttft_s=response[-1].first_token_at - ingress,
            app_share_s=start - ingress,
            queue_s=None if mid not in produced_at else ingress + wall_offset - produced_at[mid],
            resumed=max(h.resumed_len for h in mine), shared=max(h.shared_len for h in mine),
            resumed_past_head=any(h.resumed_len > h.shared_len for h in mine),
            response_tokens=response[-1].generated, chunk_chars=len(texts.get(mid, "")),
            grafted=response[-1].grafted))
        log(f"  app turn {mid} ({card}): TTFT from ingress {rows[-1]['ttft_s']:.3f} s, of which "
            f"the app before the agent's turn {rows[-1]['app_share_s'] * 1e3:.2f} ms"
            + ("" if rows[-1]["queue_s"] is None else
               f"; produce -> ingress {rows[-1]['queue_s'] * 1e3:.1f} ms")
            + f"; {rows[-1]['shared']} shared, {rows[-1]['resumed']} resumed tokens; response "
            f"{rows[-1]['response_tokens']} tokens, {rows[-1]['chunk_chars']} text chars")
    kafka_rows = [r for r in rows if r["message_id"] != "app-http-1"]
    turn2 = [r for r in rows if r["message_id"].endswith("-t2")]
    if hits1 <= 0:
        fail("app turns: turn 1 did not hit the heads the app registered")
    if session_hits < APP_TURN2 or not all(r["resumed_past_head"] for r in turn2):
        fail(f"app turns: turn 2 did not resume through the session cache: hits "
             f"{session_hits}, rows {turn2}")
    ttft = sorted(r["ttft_s"] for r in kafka_rows)
    share = sorted(r["app_share_s"] for r in kafka_rows)
    http_row = rows[-1]
    out.update(
        build_s=build_s, weights_s=timed["weights_s"], warmup_s=timed["warmup_s"],
        weights_gb=timed["weights_gb"], build_peak_gb=build_peak,
        phase_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
        turns_s=turns_s, drain_s=drain_s, prefix_hits_turn1=hits1,
        session_hits_turn2=session_hits, dedupe=dedupe, http=http_out,
        ttft_p50_s=statistics.median(ttft), ttft_s=ttft,
        app_share_p50_s=statistics.median(share), http_ttft_s=http_row["ttft_s"],
        http_app_share_s=http_row["app_share_s"], turns=rows, teacher_forced=checks,
        journaled=journaled)
    del app, engine, sched, params, handles, recording_submit, submit, retriever
    del recording_node, retrieve_node
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  app turns ({card}): {len(kafka_rows)} Kafka turns in {turns_s:.2f} s; TTFT from "
        f"ingress p50 {out['ttft_p50_s']:.3f} s, the app's share p50 "
        f"{out['app_share_p50_s'] * 1e3:.2f} ms; /chat/stream TTFT {out['http_ttft_s']:.3f} s "
        f"(the app's share {out['http_app_share_s'] * 1e3:.2f} ms); prefix hits turn 1 "
        f"{hits1:.0f}, session hits turn 2 {session_hits:.0f}; {len(checks)} streams "
        f"teacher-forced; the phase took {out['phase_s']:.1f} s")
    return out


# ``python -m finchat_tpu_torch`` as ``-m`` runs it, after seeding the store:
# a fresh process's in-memory store is empty, and a chat turn needs a
# conversation's context and history
CLI_BOOTSTRAP = """
import runpy, sys
import finchat_tpu_torch.serve.app as app_mod
from finchat_tpu_torch.io.store import InMemoryStore

def seeded(cfg):
    store = InMemoryStore(cfg)
    store.upsert_context("cli-1", {"user_id": "user-cli", "name": "Member", "income": 5200,
                                   "savings_goal": 600})
    store.add_user_message("cli-1", "How am I doing this month?", "user-cli", timestamp=100)
    return store

app_mod.make_store = seeded
sys.argv = ["finchat_tpu_torch", *sys.argv[1:]]
runpy.run_module("finchat_tpu_torch", run_name="__main__", alter_sys=True)
"""
CLI_TXNS = 8
# the worker's log lines the CLI turn is read from: the agent's decision,
# the retriever's row count, the agent's tool error where a plot cannot render
CLI_ARGS_LOG = "LLM requested retrieval with args:"
CLI_ROWS_LOG = r"Successfully processed (\d+) transactions"
CLI_NO_MPL_LOG = "Error running tool: No module named 'matplotlib'"
CLI_WAIT_S = 300.0


def cli_phase(torch, card: str) -> dict:
    """The CLI on the card: ``python -m finchat_tpu_torch --preset llama3-8b
    --config <json> --port <free port>`` in a subprocess (``CLI_BOOTSTRAP``
    seeds its store with one conversation), the config naming
    ``bge-base-en``, a snapshot directory, 32 new tokens and greedy
    responses. Once ``GET /health`` answers: ``POST /transactions`` of
    ``CLI_TXNS`` rows, one ``POST /chat/stream`` turn (the reference's event
    order; where it retrieved, its count must equal the plain count over
    the posted rows for the decision's arguments, read from the worker's
    log), then SIGTERM: the process must exit 0 within the shutdown
    deadline (plus a minute for its drain and exit), its log must show the
    graceful drain, and the snapshot must hold the rows. The process is
    killed on any failure."""
    import shutil
    import signal
    import tempfile

    import numpy as np

    from finchat_tpu_torch.embed.encoder import EMBED_PRESETS
    from finchat_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="finchat-cli-"))
    port = _free_port()
    overrides = {"serve.host": "127.0.0.1", "embed.preset": "bge-base-en",
                 "vector.persist_path": str(tmp / "vectors"), "engine.max_new_tokens": 32,
                 "engine.temperature": 0.0}
    (tmp / "config.json").write_text(json.dumps(overrides))
    deadline = load_config(overrides=overrides).shutdown.deadline_seconds
    log_path = tmp / "cli.log"
    rng = np.random.default_rng(22)
    rows = transaction_rows(rng, "user-cli", CLI_TXNS, time.time(), 30)
    out: dict = {}
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-c", CLI_BOOTSTRAP, "--preset", "llama3-8b", "--config",
             str(tmp / "config.json"), "--port", str(port)],
            cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=log_file,
            stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        health = None
        while health is None and proc.poll() is None:
            if time.perf_counter() - t0 > CLI_WAIT_S:
                break
            try:
                health = _http(port, "GET", "/health")
            except OSError:
                time.sleep(0.5)
        out["startup_s"] = time.perf_counter() - t0
        if health != (200, "application/json", '{"status": "healthy"}'):
            fail(f"cli: /health answered {health} after {out['startup_s']:.1f} s (exit "
                 f"{proc.poll()}): {log_path.read_text()[-3000:]}")
        answer = _http(port, "POST", "/transactions", {"user_id": "user-cli", "transactions": [
            {"text": r["text"], "date": r["date"], "amount": r["amount"]} for r in rows]})
        if answer[0] != 200 or json.loads(answer[2]) != {"upserted": CLI_TXNS}:
            fail(f"cli: POST /transactions answered {answer}")
        t1 = time.perf_counter()
        status, ctype, text = _http(port, "POST", "/chat/stream",
                                    {"conversation_id": "cli-1", "user_id": "user-cli",
                                     "message": "Where did my money go this month?"})
        out["turn_s"] = time.perf_counter() - t1
        sse = [json.loads(line[6:]) for line in text.split("\n") if line.startswith("data: ")]
        if (status, ctype) != (200, "text/event-stream"):
            fail(f"cli: /chat/stream answered {status} {ctype}: {text[:500]}")
        out["retrieved"], out["count"] = check_turn_protocol("bf16", "cli /chat/stream", sse)
        if out["retrieved"]:
            # the decision's arguments, from the worker's log, against the
            # plain count over the rows posted (the window's edge taken at
            # both ends of the turn)
            worker_log = log_path.read_text()
            calls = [ast.literal_eval(line.split(CLI_ARGS_LOG, 1)[1].strip())
                     for line in worker_log.splitlines() if CLI_ARGS_LOG in line]
            if len(calls) != 1:
                fail(f"cli: the turn retrieved, but the log holds {len(calls)} decisions")
            out["args"] = call = calls[0]
            n, days = call.get("num_transactions"), call.get("time_period_days")
            wants = set()
            for now in (time.time() - (time.perf_counter() - t1), time.time()):
                if isinstance(n, int) and n <= 0:
                    continue  # the count depends on the path (plain_count)
                window = [r for r in rows if not days or r["date"] >= now - days * 86_400.0]
                wants.add(min(int(n or 10_000), len(window)))
            out["plain_count"] = sorted(wants)
            # each retrieval's own count, as the retriever logs it
            processed = [int(k) for k in re.findall(CLI_ROWS_LOG, worker_log)]
            out["render_failed"] = CLI_NO_MPL_LOG in worker_log
            if out["render_failed"]:
                # a plot call on a machine without matplotlib: as in the
                # reference, the render's ImportError turns the tool's rows
                # into one error entry; the retrieval beneath it still ran
                ok = ("chart_type" in call and out["count"] == 1
                      and importlib.util.find_spec("matplotlib") is None
                      and bool(processed) and (not wants or processed[-1] in wants))
            else:
                ok = (not wants or out["count"] in wants) and 0 <= out["count"] <= CLI_TXNS
            if not ok:
                fail(f"cli: the turn ({call}) retrieved {out['count']} rows (the retriever "
                     f"logged {processed}; the render failed: {out['render_failed']}), the "
                     f"plain count {sorted(wants)} of {CLI_TXNS}")
        out["events"] = len(sse)
        t2 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=deadline + 60.0)
        except subprocess.TimeoutExpired:
            rc = None
        out["exit_s"] = time.perf_counter() - t2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log_path.read_text()
    if rc != 0 or "graceful drain" not in text or "worker up: preset=llama3-8b" not in text:
        fail(f"cli: exit {rc} after SIGTERM ({out['exit_s']:.1f} s): {text[-3000:]}")
    snap = tmp / "vectors" / "transactions"
    payloads = [json.loads(line)["payload"]["page_content"]
                for line in Path(str(snap) + ".jsonl").read_text().splitlines()] \
        if Path(str(snap) + ".jsonl").exists() else []
    with np.load(str(snap) + ".npz") as data:
        shape = tuple(data["vectors"].shape)
    if payloads != [r["text"] for r in rows] or \
            shape != (CLI_TXNS, EMBED_PRESETS["bge-base-en"].dim):
        fail(f"cli: the snapshot holds {payloads} ({shape})")
    shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  cli ({card}): python -m finchat_tpu_torch up in {out['startup_s']:.1f} s; "
        f"/chat/stream {out['events']} events in {out['turn_s']:.2f} s (retrieved "
        f"{out['retrieved']}, {out['count']} rows); SIGTERM to exit 0 in {out['exit_s']:.2f} s "
        f"(deadline {deadline:.0f} s), the snapshot of {CLI_TXNS} rows written; the phase took "
        f"{out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# checkpoint_phase: HF checkpoints written, loaded (bf16, int8 at load) and
# served through build_app
# --------------------------------------------------------------------------

CKPT_SHARDS = 4
CKPT_MIN_FREE_GB = 20.0
CKPT_MAX_RSS_GROWTH_GB = 4.0
CKPT_TURNS = 2
# the port's stacked layer leaves and their HF names in one layer, with
# whether HF stores the transpose ([out, in] against our [in, out])
HF_LLAMA_LAYER = {
    "attn_q": ("self_attn.q_proj.weight", True), "attn_k": ("self_attn.k_proj.weight", True),
    "attn_v": ("self_attn.v_proj.weight", True), "attn_o": ("self_attn.o_proj.weight", True),
    "ln_attn": ("input_layernorm.weight", False),
    "ln_mlp": ("post_attention_layernorm.weight", False),
    "mlp_gate": ("mlp.gate_proj.weight", True), "mlp_up": ("mlp.up_proj.weight", True),
    "mlp_down": ("mlp.down_proj.weight", True),
}
# Mixtral's experts: the port's expert leaves and HF's name of each expert's
# weight (``block_sparse_moe.experts.{e}.<name>.weight``, stored [out, in])
HF_MOE_EXPERTS = {"moe_gate": "w1", "moe_up": "w3", "moe_down": "w2"}
HF_BERT_LAYER = {
    "attn_out": ("attention.output.dense.weight", True),
    "attn_out_bias": ("attention.output.dense.bias", False),
    "ln1_scale": ("attention.output.LayerNorm.weight", False),
    "ln1_bias": ("attention.output.LayerNorm.bias", False),
    "mlp_in": ("intermediate.dense.weight", True),
    "mlp_in_bias": ("intermediate.dense.bias", False),
    "mlp_out": ("output.dense.weight", True), "mlp_out_bias": ("output.dense.bias", False),
    "ln2_scale": ("output.LayerNorm.weight", False), "ln2_bias": ("output.LayerNorm.bias", False),
}


def write_hf_llama(torch, params, config, path, n_shards: int = CKPT_SHARDS) -> None:
    """Write a stacked Llama tree as an HF checkpoint (the layout inversion
    of ``checkpoints/hf_loader.py``, kept here as test scaffolding): each
    layer's ``[in, out]`` slice passed as a transposed view, which the
    port's writer makes contiguous on the card (HF's ``[out, in]``) and
    copies to the host one tensor at a time, the layers split evenly over
    ``model-0000k-of-0000n.safetensors`` (the embedding in the first shard,
    the norm and the head in the last), and a ``config.json`` with the
    preset's keys. An MoE tree is written as Mixtral's: each layer's router
    as ``block_sparse_moe.gate`` ([E, D], fp32) and each expert's slice of
    the expert leaves as ``block_sparse_moe.experts.{e}.w1/w3/w2``."""
    from finchat_tpu_torch.checkpoints.safetensors_io import save_file

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    L, E = config.n_layers, config.n_experts
    layers = params["layers"]
    per = -(-L // n_shards)
    for k in range(n_shards):
        tensors = {}
        if k == 0:
            tensors["model.embed_tokens.weight"] = params["embed"]
        for i in range(k * per, min(L, (k + 1) * per)):
            for leaf, (name, transpose) in HF_LLAMA_LAYER.items():
                if leaf in layers:
                    t = layers[leaf][i]
                    tensors[f"model.layers.{i}.{name}"] = t.t() if transpose else t
            if E:
                moe = f"model.layers.{i}.block_sparse_moe"
                tensors[f"{moe}.gate.weight"] = layers["router"][i].t()
                for leaf, name in HF_MOE_EXPERTS.items():
                    for e in range(E):
                        tensors[f"{moe}.experts.{e}.{name}.weight"] = layers[leaf][i, e].t()
        if k == n_shards - 1:
            tensors["model.norm.weight"] = params["norm"]
            tensors["lm_head.weight"] = params["lm_head"].t()
        save_file(tensors, path / f"model-{k + 1:05d}-of-{n_shards:05d}.safetensors",
                  metadata={"format": "pt"})
    moe = dict(num_local_experts=E, num_experts_per_tok=config.top_k_experts) if E else {}
    (path / "config.json").write_text(json.dumps({
        "architectures": ["MixtralForCausalLM" if E else "LlamaForCausalLM"],
        "model_type": "mixtral" if E else "llama", **moe,
        "hidden_size": config.dim, "num_hidden_layers": L,
        "num_attention_heads": config.n_heads, "num_key_value_heads": config.n_kv_heads,
        "intermediate_size": config.hidden_dim, "vocab_size": config.vocab_size,
        "rope_theta": config.rope_theta, "rms_norm_eps": config.norm_eps,
        "max_position_embeddings": config.max_seq_len, "tie_word_embeddings": False,
        "torch_dtype": str(config.dtype).removeprefix("torch.")}, indent=1))


def write_hf_bert(torch, params, config, path) -> None:
    """Write an encoder tree as an HF ``BertModel`` checkpoint: q/k/v
    un-fused from ``qkv``/``qkv_bias``, every matmul weight transposed to
    ``[out, in]``, a zero token-type table (so the loader's fold gives the
    position table back), and a ``config.json``."""
    from finchat_tpu_torch.checkpoints.safetensors_io import save_file

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    D, layers = config.dim, params["layers"]
    tensors = {
        "embeddings.word_embeddings.weight": params["tok_embed"],
        "embeddings.position_embeddings.weight": params["pos_embed"],
        "embeddings.token_type_embeddings.weight": torch.zeros(
            (2, D), dtype=config.dtype, device=params["pos_embed"].device),
        "embeddings.LayerNorm.weight": params["embed_ln_scale"],
        "embeddings.LayerNorm.bias": params["embed_ln_bias"],
    }
    for i in range(config.n_layers):
        for j, name in enumerate(("query", "key", "value")):
            cols = slice(j * D, (j + 1) * D)
            tensors[f"encoder.layer.{i}.attention.self.{name}.weight"] = \
                layers["qkv"][i][:, cols].t()
            tensors[f"encoder.layer.{i}.attention.self.{name}.bias"] = layers["qkv_bias"][i][cols]
        for leaf, (name, transpose) in HF_BERT_LAYER.items():
            t = layers[leaf][i]
            tensors[f"encoder.layer.{i}.{name}"] = t.t() if transpose else t
    save_file(tensors, path / "model.safetensors", metadata={"format": "pt"})
    (path / "config.json").write_text(json.dumps({
        "architectures": ["BertModel"], "model_type": "bert", "hidden_size": D,
        "num_hidden_layers": config.n_layers, "num_attention_heads": config.n_heads,
        "intermediate_size": config.hidden_dim, "vocab_size": config.vocab_size,
        "max_position_embeddings": config.max_position, "type_vocab_size": 2,
        "layer_norm_eps": config.norm_eps, "hidden_act": "gelu"}, indent=1))


def tree_leaves(tree, prefix: str = ""):
    """``(path, tensor)`` of a parameter tree, a quantized leaf as its
    ``.q`` and ``.scale``."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from tree_leaves(value, f"{prefix}{name}/")
        elif hasattr(value, "q") and hasattr(value, "scale"):
            yield f"{prefix}{name}.q", value.q
            yield f"{prefix}{name}.scale", value.scale
        else:
            yield prefix + name, value


def bit_equal(torch, a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


class _RssPeak:
    """This process's resident set (``VmRSS`` of ``/proc/self/status``),
    sampled every 10 ms by a thread while the block runs: ``start`` and
    ``peak`` bytes."""

    @staticmethod
    def read() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def __enter__(self):
        import threading

        self.start = self.peak = self.read()
        self._stop = threading.Event()

        def run():
            while not self._stop.wait(0.01):
                self.peak = max(self.peak, self.read())

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.read())


async def checkpoint_phase(torch, dev, card: str) -> dict:
    """HF checkpoints on the card. ``llama3-8b``'s seeded
    random bf16 tree (``model.seed``, as ``build_app`` makes it) and
    ``bge-base-en``'s (seed 1) are written as HF safetensors checkpoints
    into a temporary directory (``write_hf_llama``: four shards and a
    ``config.json``; ``write_hf_bert``); the phase fails first when that
    filesystem has under ``CKPT_MIN_FREE_GB`` free. Then:

    - a bf16 load (``checkpoints/hf_loader.load_llama_params``): every leaf
      bit-equal to the source's; its seconds, device memory above the
      source tree and the process's peak RSS;
    - an int8 load (``quant="int8"``, quantized at load): every leaf
      bit-equal to ``quantize_stacked`` of the source leaf; its seconds and
      its own peak device memory against the int8 tree plus one bf16 leaf;
    - ``build_app`` over both checkpoints (``model.quant="int8"``,
      ``engine.kv_quant="int8"``, ``EngineConfig()`` otherwise, warmed up;
      the wide ``ByteTokenizer`` as in ``app_turns``): the app's encoder
      embeds a query bit-equal to an encoder over the source bge tree, then
      ``CKPT_TURNS`` Kafka turns through the consume loop, the chunk
      protocol held, every stream teacher-forced on the loaded tree
      (``teacher_forced_check``, the decision under its grammar), every
      int8 serving kernel launched under the serve's launch rules and no
      older body (counts set to 0 after the build). It prints the write and
      load seconds, the memory, and each turn's TTFT from Kafka ingress and
      its response's decode rate. The directory is removed at the end."""
    import resource
    import shutil
    import tempfile

    import numpy as np

    import finchat_tpu_torch.serve.app as app_mod
    from finchat_tpu_torch.checkpoints.hf_loader import load_llama_params
    from finchat_tpu_torch.embed.encoder import EMBED_PRESETS, EmbeddingEncoder, init_bert_params
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.models.llama import PRESETS, init_params
    from finchat_tpu_torch.models.quant import QTensor, quantize_stacked
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.utils.config import (AI_RESPONSE_TOPIC, USER_MESSAGE_TOPIC, KafkaConfig,
                                                load_config)
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    t_phase = time.perf_counter()
    spec = PLANES["int8+kv8"]
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.gettempdir()
    free_gb = shutil.disk_usage(root).free / 1e9
    log(f"  checkpoint ({card}): {free_gb:.1f} GB free under {root} (the phase needs "
        f"{CKPT_MIN_FREE_GB:.0f}); peak RSS of the process so far "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} GB")
    if free_gb < CKPT_MIN_FREE_GB:
        fail(f"checkpoint: {free_gb:.1f} GB free under {root}, the phase needs "
             f"{CKPT_MIN_FREE_GB:.0f} GB for the 8B checkpoint")
    tmp = Path(tempfile.mkdtemp(prefix="finchat-ckpt-"))
    out: dict = dict(free_gb=free_gb)
    try:
        base_cfg = load_config(overrides={"model.preset": "llama3-8b"})
        config = PRESETS["llama3-8b"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(base_cfg.model.seed)
        source = init_params(config, gen, dev)
        embed_cfg = EMBED_PRESETS["bge-base-en"]
        bgen = torch.Generator(device=dev)
        bgen.manual_seed(1)
        bge = init_bert_params(embed_cfg, bgen, dev)
        torch.cuda.synchronize()
        llama_dir, bge_dir = tmp / "llama3-8b", tmp / "bge-base-en"
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            write_hf_llama(torch, source, config, llama_dir)
            write_hf_bert(torch, bge, embed_cfg, bge_dir)
            out["write_s"] = time.perf_counter() - t0
        out["write_rss_peak_gb"] = rss.peak / 1e9
        rss_growth = {"write": (rss.peak - rss.start) / 1e9}
        out["checkpoint_gb"] = sum(f.stat().st_size for f in llama_dir.glob("*.safetensors")) / 1e9
        log(f"  checkpoint write ({card}): llama3-8b {out['checkpoint_gb']:.2f} GB in "
            f"{CKPT_SHARDS} shards and bge-base-en in {out['write_s']:.1f} s; peak RSS "
            f"{out['write_rss_peak_gb']:.2f} GB")

        # the bf16 load, against the source tree
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            loaded = load_llama_params(llama_dir, config, device=dev)
            torch.cuda.synchronize()
            out["bf16_load_s"] = time.perf_counter() - t0
        out["bf16_load_rss_peak_gb"] = rss.peak / 1e9
        rss_growth["bf16_load"] = (rss.peak - rss.start) / 1e9
        out["bf16_load_peak_above_source_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        want = dict(tree_leaves(source))
        got = dict(tree_leaves(loaded))
        bad = [n for n in want if n not in got or not bit_equal(torch, got[n], want[n])]
        log(f"  checkpoint bf16 load ({card}): {len(got)} leaves in {out['bf16_load_s']:.1f} s, "
            f"{len(want) - len(bad)}/{len(want)} bit-equal to the source; device memory above "
            f"the source tree at peak {out['bf16_load_peak_above_source_gb']:.2f} GB; peak RSS "
            f"{out['bf16_load_rss_peak_gb']:.2f} GB")
        if bad or sorted(got) != sorted(want):
            fail(f"checkpoint: the bf16 load differs from the source at {bad or sorted(got)}")
        del loaded, got
        gc.collect()
        torch.cuda.empty_cache()

        # the int8 load, quantized at load, against quantize_stacked of the source
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            q = load_llama_params(llama_dir, config, device=dev, quant="int8")
            torch.cuda.synchronize()
            out["int8_load_s"] = time.perf_counter() - t0
        out["int8_load_rss_peak_gb"] = rss.peak / 1e9
        rss_growth["int8_load"] = (rss.peak - rss.start) / 1e9
        out["int8_load_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        out["int8_tree_gb"] = sum(t.numel() * t.element_size() for _n, t in tree_leaves(q)) / 1e9
        largest = max(t.numel() * t.element_size() for _n, t in tree_leaves(source))
        out["largest_bf16_leaf_gb"] = largest / 1e9
        n_leaves, bad = 0, []
        for group in ("", "layers"):
            tree, src = (q, source) if not group else (q[group], source[group])
            for name, leaf in tree.items():
                if isinstance(leaf, dict):
                    continue
                n_leaves += 1
                ref = quantize_stacked(src[name], mode="int8") if isinstance(leaf, QTensor) \
                    else src[name]
                pairs = [(leaf.q, ref.q), (leaf.scale, ref.scale)] if isinstance(leaf, QTensor) \
                    else [(leaf, ref)]
                if not all(bit_equal(torch, a, b) for a, b in pairs):
                    bad.append(f"{group}/{name}".lstrip("/"))
                del ref, pairs
        log(f"  checkpoint int8 load ({card}): {n_leaves} leaves in {out['int8_load_s']:.1f} s, "
            f"{n_leaves - len(bad)}/{n_leaves} bit-equal to quantize_stacked of the source; peak "
            f"device memory of the load {out['int8_load_peak_gb']:.2f} GB (the int8 tree "
            f"{out['int8_tree_gb']:.2f} GB + the largest bf16 leaf {largest / 1e9:.2f} GB = "
            f"{out['int8_tree_gb'] + largest / 1e9:.2f}); peak RSS "
            f"{out['int8_load_rss_peak_gb']:.2f} GB")
        if bad:
            fail(f"checkpoint: the int8 load differs from quantize_stacked of the source at {bad}")
        del q, source
        gc.collect()
        torch.cuda.empty_cache()
        out["rss_peak_process_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        out["rss_growth_gb"] = rss_growth
        log(f"  checkpoint host memory ({card}): RSS grew by at most "
            + ", ".join(f"{k} {v:.2f} GB" for k, v in rss_growth.items())
            + f" over the 16 GB streamed; the process's peak RSS {out['rss_peak_process_gb']:.2f} GB")
        # one tensor's host copy (the 1 GB embedding or head) at a time, not the tree
        if max(rss_growth.values()) > CKPT_MAX_RSS_GROWTH_GB:
            fail(f"checkpoint: the streamed write or a load grew the RSS by more than "
                 f"{CKPT_MAX_RSS_GROWTH_GB} GB: {rss_growth}")

        # serve both checkpoints through build_app on the int8+kv8 plane
        cfg = load_config(overrides={
            "model.preset": "llama3-8b", "model.checkpoint_path": str(llama_dir),
            "model.quant": "int8", "engine.kv_quant": "int8", "embed.preset": "bge-base-en",
            "embed.checkpoint_path": str(bge_dir), "engine.max_new_tokens": AGENT_NEW,
            "engine.temperature": 0.0, "kafka.commit_after_process": True,
            "engine.session_cache_disk_path": f"{tmp}/sessions", "journal.path": f"{tmp}/journal",
            "tracing.flight_dir": f"{tmp}/flight"})
        store = InMemoryStore()
        t_hist = int(time.time()) - 600
        for i in range(CKPT_TURNS):
            store.upsert_context(f"ckpt-{i}", _app_context(i))
            store.add_user_message(f"ckpt-{i}", MESSAGES[i], f"user-app-{i}", timestamp=t_hist)
        broker = InMemoryBroker()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        app = app_mod.build_app(cfg, store=store, kafka=KafkaClient(cfg.kafka, broker=broker),
                                device=dev)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        out["app_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
        sched = app.scheduler
        engine = sched.engine
        config = engine.config
        tok = app.agent.tool_generator.tokenizer
        query = "What did I spend on groceries and rent last month?"
        source_encoder = EmbeddingEncoder(embed_cfg, bge, tok, batch_size=cfg.embed.batch_size,
                                          device=dev)
        got_v = app.retriever.encoder.embed_query(query)
        want_v = source_encoder.embed_query(query)
        out["embedding_bit_equal"] = bool(np.array_equal(got_v.view(np.uint32),
                                                         want_v.view(np.uint32)))
        log(f"  checkpoint app ({card}): build_app over both checkpoints in {out['build_s']:.1f} s "
            f"({engine.compiled_variants} step variants warmed up; {out['app_gb']:.2f} GB); the "
            f"app's encoder embeds a query bit-equal to the source encoder: "
            f"{out['embedding_bit_equal']}")
        if not out["embedding_bit_equal"] or not isinstance(engine.params["layers"]["mlp_up"],
                                                            QTensor):
            fail("checkpoint: the app's encoder differs from the source, or its weights are not "
                 "the int8 load")
        del source_encoder, bge
        app.agent.tool_sampling = SamplingParams(temperature=0.0, max_new_tokens=DECISION_NEW,
                                                 grammar="tool_call")
        handles: list = []
        submit = sched.submit

        async def recording_submit(*a, **k):
            h = await submit(*a, **k)
            handles.append(h)
            return h

        sched.submit = recording_submit
        counts = _Counts(engine)
        watcher = KafkaClient(KafkaConfig(), broker=broker)
        watcher.setup_consumer(topics=[AI_RESPONSE_TOPIC])
        producer = KafkaClient(KafkaConfig(), broker=broker)
        outbound: list = []
        payloads: dict = {}

        def completes() -> int:
            while (m := watcher.poll_message()) is not None:
                outbound.append(m.value())
            return sum(json.loads(v).get("type") == "complete" for v in outbound)

        m0 = METRICS.snapshot()
        reset_launches()
        TRACER.clear()
        try:
            await app.start(serve_http=False)
            t0 = time.perf_counter()
            for i in range(CKPT_TURNS):
                payload = {"message": MESSAGES[i], "conversation_id": f"ckpt-{i}",
                           "user_id": f"user-app-{i}", "message_id": f"ckpt-m{i}"}
                payloads[payload["message_id"]] = payload
                producer.produce_message(USER_MESSAGE_TOPIC, payload["conversation_id"], payload)
            await _wait_for(lambda: completes() >= CKPT_TURNS,
                            "checkpoint: the turns did not complete", APP_WAIT_S)
            await _wait_for(lambda: not app._inflight, "checkpoint: a message stayed in flight")
            out["turns_s"] = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            decode_steps = _metric_delta(METRICS, m0, "finchat_decode_dispatches_total")
            rounds = _metric_delta(METRICS, m0, "finchat_mixed_dispatches_total")
            missing = [k for k in spec["kernels"] if launches[k] == 0]
            if missing:
                fail(f"checkpoint: int8 serving kernels not launched on the app's path: {missing}")
            check_window("int8+kv8", "checkpoint turns", spec, config, launches, counts,
                         decode_steps, rounds)
            out["launches"] = {k: v for k, v in launches.items() if v}
            await app.drain_and_stop()
            completes()
        finally:
            sched.submit = submit
            counts.close()
            watcher.close()
        texts = _check_chunks("checkpoint", outbound, payloads)
        vocab = await app.agent.tool_generator._grammar_vocabs["tool_call"]
        checks, rows = [], []
        for h in handles:
            if not (h.finished and h.generated > 0):
                continue
            _stream_ended("int8+kv8", "checkpoint", h, tok.eos_id)
            decision = h.conversation_id.endswith("#tool")
            checks.append(teacher_forced_check(torch, engine.params, config, h, "int8",
                                               vocab=vocab if decision else None))
        for mid in payloads:
            response = [h for h in handles
                        if h.trace_id == mid and h.conversation_id.endswith("#resp")]
            ingress = next((ev[0] for ev in TRACER.snapshot()
                            if ev[1] == mid and ev[2] == "ingress"), None)
            if ingress is None or not response or response[-1].first_token_at is None:
                fail(f"checkpoint: {mid} has no ingress or response first token")
            r = response[-1]
            span = (r.last_token_at or r.first_token_at) - r.first_token_at
            rows.append(dict(message_id=mid, ttft_s=r.first_token_at - ingress,
                             response_tokens=r.generated, chunk_chars=len(texts[mid]),
                             decode_tokens_per_s=(r.generated - 1) / span if span > 0 else None))
            log(f"  checkpoint turn {mid} ({card}): TTFT from ingress {rows[-1]['ttft_s']:.3f} s; "
                f"response {r.generated} tokens"
                + ("" if rows[-1]["decode_tokens_per_s"] is None else
                   f" at {rows[-1]['decode_tokens_per_s']:.1f} tokens/s")
                + f", {rows[-1]['chunk_chars']} text chars")
        if len(checks) < 2 * CKPT_TURNS:
            fail(f"checkpoint: {len(checks)} streams finished, want a decision and a response "
                 f"for each of {CKPT_TURNS} turns")
        out.update(turns=rows, teacher_forced=checks,
                   ttft_p50_s=statistics.median(r["ttft_s"] for r in rows))
        del app, engine, sched, handles, recording_submit, submit
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  checkpoint ({card}): write {out['write_s']:.1f} s, bf16 load "
        f"{out['bf16_load_s']:.1f} s, int8 load {out['int8_load_s']:.1f} s (peak "
        f"{out['int8_load_peak_gb']:.2f} GB); {CKPT_TURNS} turns, TTFT p50 "
        f"{out['ttft_p50_s']:.3f} s, {len(out['teacher_forced'])} streams teacher-forced; the "
        f"phase took {out['phase_s']:.1f} s")
    return out


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "attention_decode_sm90" in n:
        return ("attention ragged decode sm90 (ours)" if "raggedrows" in n
                else "attention decode sm90 (ours)")
    if "ragged_attention_bf16_sm90" in n:
        return "attention ragged sm90 (ours)"
    if any(k in n for k in ("paged_attention_kernel", "ragged_attention_kernel",
                            "attention_q8_sm90_kernel", "attention_bf16_sm90_kernel",
                            "combine_splits")):
        return "attention (ours)"
    if "kv_write" in n:
        return "kv_append sm90 (ours)"
    if "kv_append" in n:
        return "kv_append (ours)"
    if "quant_matmul_decode" in n:
        return "quant_matmul decode sm90 (ours)"
    if "quant_matmul_sm90_kernel" in n:
        return "quant_matmul sm90 (ours)"
    if "quant_matmul_kernel" in n:
        return "quant_matmul v2 (ours)"
    if any(k in n for k in ("gemm", "gemv", "xmma", "cutlass", "sm90", "nvjet", "matmul")):
        return "matmul (cuBLAS)"
    return "other"


# the engine's ``named_scope`` ranges (utils/tracing.py): under a profiler
# each also spans its kernels on the card's timeline, so it is no kernel of
# its own and is left out of the device time by class
ENGINE_RANGES = frozenset({"kv_append", "kv_scatter", "paged_attention", "kv_scatter_ragged",
                           "ragged_paged_attention", "ring_attention"})


def device_ms(torch, prof, classify, runs: int = 1, top: int = 4) -> tuple[dict, dict]:
    """Device milliseconds per run by kernel class from a profile, and the
    ``top`` largest kernels of the class "other"."""
    by_class: dict[str, float] = {}
    others: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.key in ENGINE_RANGES:
            continue  # host ops also carry their kernels' device time
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us:
            cls = classify(ev.key)
            by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3 / runs
            if cls == "other":  # names cut to 90 characters: sum what they merge
                key = ev.key[:90]
                others[key] = others.get(key, 0.0) + dev_us / 1e3 / runs
    return by_class, dict(sorted(others.items(), key=lambda x: -x[1])[:top])


PROFILED_STEPS = ("decode_step", "prefill_chunk_4x512", "ragged_round_serve")


def profile_steps(torch, engine, context: int, active: int, classify=None,
                  kinds: tuple = PROFILED_STEPS) -> dict:
    """Where a step's time goes, after serving: a decode step with ``active``
    slots at ``context`` tokens, a 4 x 512 prefill chunk at q_offset 2048,
    and a ragged round shaped like the serve's (``SERVE_ROUND``: three
    512-token chunks at q_offset 1024, 2048 and 4096 beside 4 decode rows at
    ``context``, their positions given by the host), each timed with CUDA
    events around whole steps (host enqueue included) and profiled with
    torch.profiler for device time by kernel class. The idle share is 1 -
    device busy / window, both taken in the same profiled window: CUDA events recorded inside the profile around
    its steps (the profiler's own host cost is in that window, so the share
    reads high against an unprofiled step). Uses the engine's own state
    (random KV), slots 0..active-1. ``classify`` maps a kernel's name to its
    class (``_kernel_class`` by default); ``kinds`` names the steps to
    profile."""
    from torch.profiler import ProfilerActivity, profile

    B = engine.engine_cfg.max_seqs
    per = -(-(context + 8) // engine.page_size)
    engine.set_page_table_rows({s: list(range(1 + s * per, 1 + (s + 1) * per))
                                for s in range(active)})
    engine.set_context_lens_rows({s: context for s in range(active)})
    act = [s < active for s in range(B)]
    zeros, ones, izeros = [0.0] * B, [1.0] * B, [0] * B
    prefill_args = ([[7] * 512] * 4, [0, 1, 2, 3], [2048] * 4, [512] * 4)

    def decode():
        engine.decode(act, zeros, ones, izeros)

    def prefill():
        engine.prefill_chunk(*prefill_args)

    # the round's rows on slots 0..6, every row's first position from the
    # host (so repeated rounds see the same positions), nothing committed
    R = B
    chunks = [(min(p0, context - q_len), q_len) for q_len, p0 in SERVE_ROUND if q_len > 1]
    spans = chunks + [(context - 1, 1)] * sum(q_len == 1 for q_len, _p in SERVE_ROUND)
    tok_row = [r for r, (_p, q_len) in enumerate(spans) for _ in range(q_len)]
    T = engine.ragged_bucket(len(tok_row))
    pad = [0] * (R - len(spans))
    ragged_args = ([7] * T, tok_row + [R] * (T - len(tok_row)), list(range(len(spans))) + pad,
                   [p for p, _q in spans] + pad, [q_len for _p, q_len in spans] + pad,
                   [False] * R, [False] * R, zeros, ones, izeros)

    def ragged():
        engine.ragged_mixed(*ragged_args)

    out = {}
    for name, fn in (("decode_step", decode), ("prefill_chunk_4x512", prefill),
                     ("ragged_round_serve", ragged)):
        if name not in kinds:
            continue
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        w_start = torch.cuda.Event(enable_timing=True)
        w_end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w_start.record()
            for _ in range(3):
                fn()
            w_end.record()
            torch.cuda.synchronize()
        window_ms = w_start.elapsed_time(w_end) / 3
        by_class, top_other = device_ms(torch, prof, classify or _kernel_class, runs=3)
        ev_ms = time_ms(torch, fn, iters=5, warmup=1)
        busy = sum(by_class.values())
        out[name] = dict(event_ms=ev_ms, profiled_window_ms=window_ms, device_busy_ms=busy,
                         idle_share=1.0 - busy / window_ms,
                         device_ms_by_class=by_class, top_other=top_other)
        log(f"  {name}: {ev_ms:.2f} ms per step (CUDA events); profiled {window_ms:.2f} ms "
            f"per step, device busy {busy:.2f} ms (idle share {1.0 - busy / window_ms:.3f}): "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_class.items(), key=lambda x: -x[1])))
    out["device_trace"] = check_device_trace(torch, engine, decode)
    engine.reset_slots(list(range(active)))
    return out


def check_device_trace(torch, engine, decode) -> dict:
    """``utils/tracing.device_trace`` over two decode steps: the profiler
    trace it writes must hold the engine's ``kv_append`` and
    ``paged_attention`` ranges, one a layer a step (host ranges; the card's
    copies of them counted beside)."""
    import shutil
    import tempfile

    from finchat_tpu_torch.utils.tracing import device_trace

    log_dir = tempfile.mkdtemp(prefix="finchat-profile-")
    try:
        with device_trace(log_dir):
            decode()
            decode()
        path = Path(log_dir) / "trace.json"
        trace = json.loads(path.read_text())
        size = path.stat().st_size
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    want = 2 * engine.config.n_layers
    ranges = {}
    for name in ("kv_append", "paged_attention"):
        evs = [e for e in trace["traceEvents"] if e.get("name") == name]
        ranges[name] = dict(host=sum(1 for e in evs if e.get("cat") == "user_annotation"),
                            device=sum(1 for e in evs if e.get("cat") == "gpu_user_annotation"))
    log(f"  device_trace over two decode steps: {size} bytes, ranges {ranges} (want {want} "
        "host ranges of each)")
    if any(r["host"] != want for r in ranges.values()):
        fail("device_trace: the profiler trace lacks the engine's ranges")
    return dict(bytes=size, ranges=ranges)


class _Dequantized:
    """A stacked quantized leaf read one layer at a time as its dequantized
    bf16 weight (``leaf[i]``, how the forward slices a layer), so the plain
    forward never holds the whole bf16 tree."""

    def __init__(self, leaf):
        self.leaf = leaf

    def __getitem__(self, i):
        from finchat_tpu_torch.models.quant import dequantize

        return dequantize(self.leaf[i])


def grammar_masks(vocab, served: list[int], budget: int):
    """The token sets ``TokenConstraint.pick`` chose each served token from:
    after the tokens before it (the grammar's state), with the budget left
    (the feasibility rule), EOS where the state accepts; only EOS where
    nothing is feasible. One [vocab] bool array a served token."""
    import numpy as np

    only_eos = np.zeros(len(vocab.token_strs), bool)
    only_eos[vocab.eos_id] = True
    state = vocab.dfa.start
    for i, token in enumerate(served):
        allowed, eos_ok, ends = vocab.mask(state)
        feasible = allowed & (vocab._distance_np[ends] <= budget - i - 2)
        if not (feasible.any() or eos_ok):
            yield only_eos
        else:
            allowed = feasible.copy()
            if eos_ok:
                allowed[vocab.eos_id] = True
            yield allowed if allowed.any() else only_eos
        if token != vocab.eos_id:
            state = vocab.advance(state, token)


def teacher_forced_check(torch, params, config, h, kv_quant: str, vocab=None,
                         with_margins: bool = False, visible=None) -> dict:
    """Re-run one served stream through the plain dense forward (no cache,
    plain attention, plain matmuls) and require the served greedy token
    wherever the plain forward's top-2 logit margin exceeds 0.25 — bf16
    activations through 32 layers move logits by a few hundredths, so a
    larger margin cannot flip. A quantized tree runs on its dequantized
    weights; an int8 KV cache is mirrored by quantizing and dequantizing
    every K/V row (``quantize_kv_rows``) before attention, so both sides see
    the same values. A stream that rode a shared head or resumed cached
    pages is checked over its whole history all the same: the served
    tokens must not depend on where their KV came from. With ``vocab`` (a
    grammar-constrained stream) the argmax and the margin are taken under
    the grammar mask each token was picked under (``grammar_masks``).
    ``with_margins`` adds each served token's plain top-2 margin. ``visible``
    (a bool [S, S] tensor over the history but its last token, True where
    query row p may see key j) replaces the causal mask: a bounded-KV
    stream's mask from its replayed gap schedule (``bounded_mask``)."""
    from finchat_tpu_torch.engine.kv_cache import quantize_kv_rows
    from finchat_tpu_torch.models.llama import dense_causal_attention, forward, lm_head
    from finchat_tpu_torch.models.quant import Q4Tensor, QTensor, dequantize
    from finchat_tpu_torch.ops.refs import masked_logits, mha_reference

    def plain_leaf(leaf):
        return _Dequantized(leaf) if isinstance(leaf, (QTensor, Q4Tensor)) else leaf

    plain = {**params, "layers": {n: plain_leaf(v) for n, v in params["layers"].items()}}
    if isinstance(params.get("lm_head"), (QTensor, Q4Tensor)):
        plain["lm_head"] = dequantize(params["lm_head"])

    def kv_roundtrip(x):  # [B, S, Hkv, hd]
        B, S, n_kv, hd = x.shape
        q8, sc = quantize_kv_rows(x.reshape(B, S, n_kv * hd), n_kv)
        return (q8.reshape(B, S, n_kv, hd).float() * sc[..., None]).to(x.dtype)

    def q8_attention(q, k, v, cache, layer_idx):
        return mha_reference(q, kv_roundtrip(k), kv_roundtrip(v), causal=True), cache

    def bounded_attention(q, k, v, cache, layer_idx):
        # mha_reference's arithmetic under the given mask
        if kv_quant:
            k, v = kv_roundtrip(k), kv_roundtrip(v)
        weights = torch.softmax(masked_logits(q, k, blocked, q.shape[-1] ** -0.5), dim=-1)
        v = v.repeat_interleave(q.shape[2] // v.shape[2], dim=2)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
        return out.to(q.dtype), cache

    ids = h.history[:-1]
    n_prompt = len(h.prompt_ids)
    dev = params["embed"].device
    tokens = torch.tensor([ids], dtype=torch.int64, device=dev)
    positions = torch.arange(len(ids), device=dev)[None]
    attention = q8_attention if kv_quant else dense_causal_attention
    if visible is not None:
        if tuple(visible.shape) != (len(ids), len(ids)):
            fail(f"teacher-forced check of {h.seq_id}: a {tuple(visible.shape)} mask for "
                 f"{len(ids)} tokens")
        blocked = ~visible.to(dev)[None, None]
        attention = bounded_attention
    with torch.no_grad():
        hidden, _ = forward(plain, tokens, positions, config=config, attention=attention,
                            return_hidden=True)
        logits = lm_head(plain, hidden[0, n_prompt - 1:], config=config)
    if not bool(torch.isfinite(logits).all().item()):
        fail(f"teacher-forced check of {h.seq_id}: non-finite logits from the plain forward")
    served_ids = h.history[n_prompt:]
    if vocab is not None:
        import numpy as np

        masks = torch.from_numpy(np.stack(list(grammar_masks(
            vocab, served_ids, h.sampling.max_new_tokens)))).to(dev)
        logits = logits[: masks.shape[0]].float().masked_fill(~masks, float("-inf"))
    top2 = torch.topk(logits, 2, dim=-1)
    margin = (top2.values[:, 0] - top2.values[:, 1]).cpu()
    want = top2.indices[:, 0].cpu()
    served = torch.tensor(served_ids, dtype=torch.int64)
    n = min(len(served), len(want))
    decided = margin[:n] > 0.25  # inf where the mask leaves one token
    agree = (want[:n] == served[:n])
    bad = int((decided & ~agree).sum())
    what = "the plain forward's argmax" + (" under the grammar mask" if vocab is not None else "")
    what += " under the bounded mask" if visible is not None else ""
    log(f"  teacher-forced {h.seq_id} ({n_prompt} prompt tokens, {h.shared_len} shared, "
        f"{h.resumed_len} resumed): {int(agree.sum())}/{n} served tokens equal {what}; "
        f"{int(decided.sum())} have margin > 0.25, {bad} of those disagree")
    if bad:
        fail(f"teacher-forced check: {h.seq_id}'s served tokens disagree with the plain forward")
    del plain, logits, hidden
    out = dict(seq_id=h.seq_id, tokens=n, agree=int(agree.sum()), decided=int(decided.sum()),
               masked=vocab is not None)
    if with_margins:
        out["margins"] = margin[:n].tolist()
    return out


# --------------------------------------------------------------------------
# decode_planes: the fused decode loop, spec decode, the free-running loop
# --------------------------------------------------------------------------

# the spec run's drafts a verify step: the verify-shape attention call is
# C = 1 + VERIFY_DRAFTS query tokens a slot
VERIFY_DRAFTS = 3
# the decode planes and bounded KV run at full width over 8 of the model's 32
# layers (the depth cut, not a check dropped), so the script stays inside its
# time limit with the fleet planes' and the Mixtral phases after them
PLANE_DEPTH = 8
# the runs of the phase, each an engine of its own over the plane's weights:
# the depth-1 stream first (what the others are held to), then the planes
DECODE_RUNS = {
    "bf16": (("depth1", {}), ("loop4", dict(decode_loop_depth=4)),
             ("spec3", dict(spec_tokens=VERIFY_DRAFTS)),
             ("freerun4", dict(freerun_rounds=4, decode_loop_depth=2))),
    "int8+kv8": (("depth1", {}), ("loop4", dict(decode_loop_depth=4))),
}
# a stream is held to the depth-1 stream token by token; the two may part
# only at a token whose plain-forward margin (on the depth-1 stream, the
# prefixes being equal) is at most this: the teacher-forced check's rule
STREAM_MARGIN = 0.25


class _PlaneCounts:
    """What the engine's steps of a run did, counted at the engine: calls of
    each step (prefill chunks, single decode steps, decode-loop blocks,
    verify steps, ragged rounds, captured multi-rounds) and the drafts the
    verify steps and spec rows carried."""

    NAMES = ("prefill_chunk", "decode", "decode_loop", "decode_spec", "ragged_mixed",
             "ragged_multi")

    def __init__(self, engine):
        self.engine = engine
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.drafts = 0
        for name in self.NAMES:
            real = getattr(engine, name)

            def counted(*a, _name=name, _real=real, **k):
                self.calls[_name] += 1
                if _name == "decode_spec":
                    self.drafts += int(sum(a[2]))
                elif _name == "ragged_mixed" and len(a) > 10 and a[10] is not None:
                    self.drafts += int(sum(a[10]))
                return _real(*a, **k)

            setattr(engine, name, counted)

    def close(self) -> None:
        for name in self.NAMES:
            delattr(self.engine, name)


def _state_copy(torch, state):
    """A deep copy of an engine state on the card, the generator's position
    included."""
    import dataclasses

    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)}, generator=gen)


def check_loop_graph(torch, engine, when: str, head_ids: list[int]) -> dict:
    """A replayed block of the engine's decode-loop graph against the eager
    ``decode_loop_step`` on a copy of the same state: two slots armed (the
    head's tokens as their prompts, one a page longer), one greedy block;
    the tokens, context lengths, last tokens and every page equal, and the
    replay adds the launches the capture recorded. Then the slots are
    cleared (their pages were never the allocator's)."""
    from finchat_tpu_torch.engine.engine import decode_loop_step
    from finchat_tpu_torch.ops.kernels import LAUNCHES

    B = engine.engine_cfg.max_seqs
    K = engine.decode_loop_depth
    per = -(-(len(head_ids) + engine.page_size + 8 * K) // engine.page_size)
    rows = {0: head_ids, 1: head_ids + head_ids[: engine.page_size]}
    engine.set_page_table_rows({s: list(range(1 + s * per, 1 + (s + 1) * per)) for s in rows})
    for slot, ids in rows.items():
        engine.commit_first_token(slot, engine.prefill(slot, ids), 0.0, 1.0, 0)
    graph = engine._loop_graph(K)
    active = [s in rows for s in range(B)]
    greedy = ([0.0] * B, [1.0] * B, [0] * B)
    copy = _state_copy(torch, engine.state)
    before = dict(LAUNCHES)
    got = engine.decode_loop(active, *greedy, eos_id=-1)
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    dev = engine.device
    args = [torch.tensor(a, device=dev, dtype=dt) for a, dt in
            ((active, torch.bool), (greedy[0], torch.float32), (greedy[1], torch.float32),
             (greedy[2], torch.int32))]
    _s, want = decode_loop_step(engine.params, copy, *args,
                                torch.tensor(-1, dtype=torch.int32, device=dev),
                                config=engine.config, page_size=engine.page_size, loop_depth=K)
    same = bool(torch.equal(got, want)) and all(
        torch.equal(getattr(engine.state, n), getattr(copy, n))
        for n in ("context_lens", "last_tokens", "k_pages", "v_pages"))
    if engine.state.k_scales is not None:
        same = same and all(torch.equal(getattr(engine.state, n), getattr(copy, n))
                            for n in ("k_scales", "v_scales"))
    log(f"    decode-loop graph ({when}): a replayed block of {K} equals the eager loop on a "
        f"copy of the state (tokens, context, last tokens, pages): {same}; launches a replay "
        f"{graph.launches}")
    if not same:
        fail(f"decode-loop graph ({when}): the replay disagrees with the eager decode_loop_step")
    if moved != graph.launches:
        fail(f"decode-loop graph ({when}): a replay moved the launch counts by {moved}, not "
             f"the captured {graph.launches}")
    del copy
    engine.reset_slots(list(rows))
    return dict(equal=same, launches_per_replay=graph.launches)


def check_plane_launches(label: str, spec: dict, config, launches: dict, calls: dict,
                         loop_depth: int, freerun: int) -> None:
    """The launch rules of a decode-plane run, every call counted at the
    engine: the KV-row writer of the cache takes one launch a layer for
    every forward iteration (a prefill chunk, a decode step, each of a
    block's K iterations, a verify step, a ragged round and each of its
    fused tail iterations, each round of a capture and its tails), the
    older appends none; the plane's kernels that routing keeps off the path
    none. The older paged body takes the verify steps' attention (C = 1 +
    drafts), one launch a layer of each, and nothing else."""
    L = config.n_layers
    tails = loop_depth if loop_depth > 1 else 1
    iters = (calls["prefill_chunk"] + calls["decode"] + loop_depth * calls["decode_loop"]
             + calls["decode_spec"] + tails * calls["ragged_mixed"]
             + freerun * tails * calls["ragged_multi"])
    writer, older_append = (("kv_append_q8_sm90", "kv_append_q8") if spec["kv_quant"]
                            else ("kv_append_sm90", "kv_append"))
    older = "paged_attention_q8" if spec["kv_quant"] else "paged_attention"
    log(f"    {label}: steps {calls}; KV writes {launches[writer]} (want {L * iters}); "
        f"older paged body {launches[older]} (want {L * calls['decode_spec']}, the verify "
        "steps)")
    if launches[writer] != L * iters or launches[older_append]:
        fail(f"decode_planes {label}: the KV-row writer took {launches[writer]} layer writes, "
             f"not {L * iters}, or the older append ran")
    if launches[older] != L * calls["decode_spec"]:
        fail(f"decode_planes {label}: the older paged body took {launches[older]} calls, not "
             f"one a layer of each of {calls['decode_spec']} verify steps")
    stray = {k: launches[k] for k in spec.get("never", ()) if launches[k]}
    if stray:
        fail(f"decode_planes {label}: calls reached kernels kept off this path: {stray}")
    missing = [k for k in spec["kernels"] if launches[k] == 0]
    if missing:
        fail(f"decode_planes {label}: kernels not launched on the main path: {missing}")


def _profile_call(torch, fn, reset) -> dict:
    """One engine call timed with CUDA events around whole calls and profiled
    (device busy by class, idle share of the profiled window) as
    ``profile_steps`` does; ``reset`` puts the state back before each
    measurement (two warm calls, three profiled, the events' own)."""
    from torch.profiler import ProfilerActivity, profile

    reset()
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    w_start = torch.cuda.Event(enable_timing=True)
    w_end = torch.cuda.Event(enable_timing=True)
    reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w_start.record()
        for _ in range(3):
            fn()
        w_end.record()
        torch.cuda.synchronize()
    window_ms = w_start.elapsed_time(w_end) / 3
    by_class, _top = device_ms(torch, prof, _kernel_class, runs=3)
    reset()
    ev_ms = time_ms(torch, fn, iters=5, warmup=1)
    busy = sum(by_class.values())
    return dict(event_ms=ev_ms, profiled_window_ms=window_ms, device_busy_ms=busy,
                idle_share=1.0 - busy / window_ms, device_ms_by_class=by_class)


def _by_class(p: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in sorted(p["device_ms_by_class"].items(),
                                                       key=lambda x: -x[1]))


def profile_block(torch, engine, context: int, active: int) -> dict:
    """Where a decode-loop block's time goes against a single step's, on the
    engine's own state: ``active`` slots at ``context`` tokens (random KV),
    a block (one graph replay, K iterations) and a decode step, each
    measured by ``_profile_call``."""
    B = engine.engine_cfg.max_seqs
    K = engine.decode_loop_depth
    per = -(-(context + 8 * K) // engine.page_size)
    engine.set_page_table_rows({s: list(range(1 + s * per, 1 + (s + 1) * per))
                                for s in range(active)})
    act = [s < active for s in range(B)]
    zeros, ones, izeros = [0.0] * B, [1.0] * B, [0] * B
    out = {}
    for name, fn, tokens in (
            ("decode_step", lambda: engine.decode(act, zeros, ones, izeros), 1),
            (f"decode_loop_block_k{K}",
             lambda: engine.decode_loop(act, zeros, ones, izeros, eos_id=-1), K)):
        p = _profile_call(torch, fn, lambda: engine.set_context_lens_rows(
            {s: context for s in range(active)}))
        p["ms_per_token"] = p["event_ms"] / tokens
        out[name] = p
        log(f"    {name}: {p['event_ms']:.2f} ms a call, {p['ms_per_token']:.2f} ms a token "
            f"(CUDA events); profiled {p['profiled_window_ms']:.2f} ms, device busy "
            f"{p['device_busy_ms']:.2f} ms (idle share {p['idle_share']:.3f}): {_by_class(p)}")
    engine.reset_slots(list(range(active)))
    return out


async def _plane_run(torch, dev, plane: str, label: str, extras: dict, params, config,
                     weight_gb: float, head_ids: list[int], system_prompt: str, card: str,
                     baseline: dict | None) -> dict:
    """One run of ``decode_planes``: an engine at ``EngineConfig(kv_quant=...,
    **extras)`` over the plane's weights, warmed up (the decode-loop graph
    captured there), the system head registered, 8 greedy requests of 64
    new tokens in two waves through ``LLMService``; every stream
    teacher-forced and equal to the depth-1 run's stream unless they part
    at a low-margin token; the launch rules; the plane's own checks."""
    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.engine.generator import EngineGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.simple import LLMService
    from finchat_tpu_torch.utils.config import EngineConfig
    from finchat_tpu_torch.utils.metrics import METRICS

    spec = PLANES[plane]
    name = f"{plane} {label}"
    log(f"  decode_planes {name}: EngineConfig(kv_quant={spec['kv_quant']!r}, {extras})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ecfg = EngineConfig(kv_quant=spec["kv_quant"], **extras)
    engine = InferenceEngine(config, params, ecfg, device=dev, quant=spec["quant"],
                             quant_group=spec["group"])
    warm = run_warmup(torch, name, engine, weight_gb)
    K = engine.decode_loop_depth
    graph = {}
    if K > 1:
        graph["warmup"] = check_loop_graph(torch, engine, "at warmup", head_ids)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the serve's peak, the graph's pool held
    tok = ByteTokenizer()
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    counts = _PlaneCounts(engine)
    handles = []
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    sched.submit = recording_submit
    svc = LLMService(EngineGenerator(sched, tok), system_prompt,
                     SamplingParams(temperature=0.0, max_new_tokens=AGENT_NEW))
    m0 = METRICS.snapshot()
    reset_launches()
    sched.register_prefix(head_ids)
    await sched.start()

    async def one(i: int) -> None:
        async for _chunk in svc.process_message(MESSAGES[i], context=CONTEXTS[i],
                                                conversation_id=f"dp-{i}"):
            pass

    t0 = time.perf_counter()
    wave1 = [asyncio.create_task(one(i)) for i in range(4)]
    while not any(h.generated > 0 for h in handles):
        await asyncio.sleep(0.005)
    wave2 = [asyncio.create_task(one(i)) for i in range(4, 8)]
    await asyncio.gather(*wave1, *wave2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    await sched.stop()
    sched.submit = submit
    launches = dict(LAUNCHES)
    calls = dict(counts.calls)
    drafts = counts.drafts
    counts.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(handles) != 8 or not all(h.finished and h.generated > 0 for h in handles):
        fail(f"decode_planes {name}: not every request completed with tokens")
    if not all(h.generated == AGENT_NEW or h.history[-1] == tok.eos_id for h in handles):
        fail(f"decode_planes {name}: a request ended before max_new_tokens without EOS")
    check_plane_launches(name, spec, config, launches, calls, K, engine.freerun_rounds)
    decode_tokens = sum(h.generated - 1 for h in handles)
    t_first = min(h.first_token_at for h in handles)
    t_last = max(h.last_token_at for h in handles)
    agg = decode_tokens / max(t_last - t_first, 1e-9)
    per_stream = statistics.median((h.generated - 1) / max(h.last_token_at - h.first_token_at,
                                                           1e-9) for h in handles)
    ttft = statistics.median(h.first_token_at - h.submitted_at for h in handles)
    checks, margins, held = [], {}, {}
    for h in handles:
        c = teacher_forced_check(torch, params, config, h, spec["kv_quant"], with_margins=True)
        margins[h.conversation_id] = c.pop("margins")
        checks.append(c)
    out = dict(label=label, config=extras, warmup=warm, wall_s=wall, ttft_p50_s=ttft,
               decode_tokens_per_s=agg, decode_tokens_per_s_per_stream=per_stream,
               calls=calls, peak_gb=peak_gb, teacher_forced=checks,
               streams={h.conversation_id: h.history[len(h.prompt_ids):] for h in handles},
               margins=margins)
    if baseline is not None:
        for conv, served in out["streams"].items():
            want, marg = baseline["streams"][conv], baseline["margins"][conv]
            n = 0
            while n < min(len(served), len(want)):
                if served[n] != want[n]:
                    # the prefixes are equal: the depth-1 stream's plain
                    # margin at n decides whether the token may differ
                    if marg[n] > STREAM_MARGIN:
                        fail(f"decode_planes {name}: {conv}'s token {n} is {served[n]}, the "
                             f"depth-1 stream's {want[n]} (margin {marg[n]:.3f})")
                    break
                n += 1
            held[conv] = n
        log(f"    {name}: streams equal the depth-1 streams over {sum(held.values())} of "
            f"{sum(len(s) for s in out['streams'].values())} tokens (each up to a token of "
            f"plain margin <= {STREAM_MARGIN} where they part, if they do): {held}")
        out["held_to_depth1"] = held
    m = lambda k: _metric_delta(METRICS, m0, k)  # noqa: E731
    if K > 1:
        blocks = m("finchat_decode_loop_blocks_total")
        out["loop"] = dict(blocks=blocks, wasted=m("finchat_decode_loop_wasted_tail_tokens_total"),
                           graph=graph)
        log(f"    {name}: {blocks:.0f} blocks of {K}, wasted tail tokens "
            f"{out['loop']['wasted']:.0f}")
        if calls["decode_loop"] < 1 or blocks != calls["decode_loop"]:
            fail(f"decode_planes {name}: {calls['decode_loop']} blocks dispatched, "
                 f"finchat_decode_loop_blocks_total moved {blocks}")
    if engine.engine_cfg.spec_tokens:
        accepted = m("finchat_spec_tokens_accepted_total")
        out["spec"] = dict(verify_steps=calls["decode_spec"], drafts=drafts, accepted=accepted,
                           acceptance=accepted / drafts if drafts else None,
                           demotions=m("finchat_spec_demotions_total"))
        log(f"    {name}: {calls['decode_spec']} verify steps, {drafts} drafts, {accepted:.0f} "
            f"accepted (acceptance {accepted / max(drafts, 1):.3f}), demotions "
            f"{out['spec']['demotions']:.0f}")
        if calls["decode_spec"] < 1 or accepted < 1:
            fail(f"decode_planes {name}: no verify step with an accepted draft")
    if engine.freerun_rounds > 1:
        fr = m("finchat_freerun_dispatches_total")
        rounds, disp = m("finchat_coexist_rounds_total"), m("finchat_coexist_dispatches_total")
        out["freerun"] = dict(dispatches=fr, coexist_rounds=rounds, coexist_dispatches=disp,
                              dispatches_per_round=disp / rounds if rounds else None,
                              epoch_breaks=m("finchat_freerun_epoch_breaks_total"),
                              divergences=m("finchat_freerun_divergences_total"))
        log(f"    {name}: {fr:.0f} captured dispatches; coexist dispatches {disp:.0f} over "
            f"{rounds:.0f} rounds ({disp / max(rounds, 1):.3f} a round); epoch breaks "
            f"{out['freerun']['epoch_breaks']:.0f}, divergences "
            f"{out['freerun']['divergences']:.0f}")
        if fr < 1 or not rounds or disp / rounds >= 1 or out["freerun"]["divergences"]:
            fail(f"decode_planes {name}: the free-running loop did not capture (dispatches "
                 f"{fr}, {disp} a {rounds} rounds, divergences {out['freerun']['divergences']})")
    if K > 1 and engine.freerun_rounds == 1:
        out["profile"] = profile_block(torch, engine, context=max(len(h.prompt_ids)
                                                                  for h in handles), active=8)
    out["launches"] = launches
    log(f"    {name}: {len(handles)} requests in {wall:.2f} s; TTFT p50 {ttft:.3f} s; decode "
        f"{agg:.1f} tokens/s aggregate, {per_stream:.1f} per stream; peak {peak_gb:.2f} GB "
        f"(weights {weight_gb:.2f}, pool {pool_bytes(engine) / 1e9:.2f}) ({card})")
    sched.retire_prefixes()
    if sched.allocator.used_count:
        fail(f"decode_planes {name}: {sched.allocator.used_count} pages left allocated")
    if K > 1:
        engine.rebuild_device_state()
        if engine._loop_graphs:
            fail(f"decode_planes {name}: the graph survived rebuild_device_state")
        graph["rebuild"] = check_loop_graph(torch, engine, "after rebuild_device_state",
                                            head_ids)
    del engine, sched, svc, recording_submit, submit, counts
    gc.collect()
    torch.cuda.empty_cache()
    return out


async def decode_planes(torch, dev, card: str) -> dict:
    """The decode planes at ``llama3-8b`` full width over ``PLANE_DEPTH`` of
    its layers, random weights from a seeded generator, greedy
    (``DECODE_RUNS``): on bf16 the depth-1 run,
    ``decode_loop_depth=4``, ``spec_tokens=3`` and ``freerun_rounds=4`` with
    ``decode_loop_depth=2``; on int8+kv8 the depth-1 run and
    ``decode_loop_depth=4``. Each run's launches are a window of their own
    (counts set to 0 just before the head's registration); the spec run's
    window is the one the verify-shape attention's ``kernels`` row reads."""
    import dataclasses

    from finchat_tpu_torch.models.llama import PRESETS, init_params
    from finchat_tpu_torch.models.quant import init_quantized_params
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat_head

    config = dataclasses.replace(PRESETS["llama3-8b"], n_layers=PLANE_DEPTH)
    system_prompt = (REPO / "prompts" / "system_prompt.txt").read_text()
    head_ids = ByteTokenizer().encode(render_chat_head(system_prompt), add_bos=True)[:-1]
    t0 = time.perf_counter()
    out = {}
    for plane, runs in DECODE_RUNS.items():
        spec = PLANES[plane]
        _free(torch)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        base = torch.cuda.memory_allocated()
        if spec["quant"]:
            params = init_quantized_params(config, gen, dev, mode=spec["quant"],
                                           group_size=spec["group"])
        else:
            params = init_params(config, gen, dev)
        torch.cuda.synchronize()
        weight_gb = (torch.cuda.memory_allocated() - base) / 1e9
        baseline = None
        for label, extras in runs:
            r = await _plane_run(torch, dev, plane, label, extras, params, config, weight_gb,
                                 head_ids, system_prompt, card, baseline)
            if baseline is None:
                baseline = r
            out[f"{plane} {label}"] = r
        for r in out.values():
            r.pop("margins", None)
        del params, baseline
        _free(torch)
    for r in out.values():
        r.pop("streams", None)
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# bounded_kv: sink + window eviction through the Hopper bodies
# --------------------------------------------------------------------------

# a sink of 1 page and a window of 16 (17 pages of 128 = 2,176 tokens), below
# every Penny prompt, so every row evicts during prefill and decode; the
# window is >= ceil(512 / 128) + 2, as the policy's validation requires
BOUNDED = dict(kv_sink_pages=1, kv_window_pages=16)
# (plane, label, EngineConfig extras, the system head registered). With a
# bounded policy a registered head is cut to the sink's pages (at
# registration and at admission, as in the JAX package), so the head run
# pins 1 page and keeps the 16-page window: every row still evicts.
BOUNDED_RUNS = (
    ("bf16", "depth1", dict(BOUNDED), False),
    ("bf16", "loop4", dict(BOUNDED, decode_loop_depth=4), False),
    ("bf16", "head", dict(BOUNDED), True),
    ("int8+kv8", "depth1", dict(BOUNDED), False),
)


def replay_gaps(policy, prompt_len: int, start: int, n_written: int, chunk: int,
                capacity: int, pinned: int) -> tuple[list[int], int, int]:
    """The gap each written position of a bounded row was computed under,
    from ``BoundedKVPolicy.plan_eviction`` alone: a wave before every
    dispatch, a prefill dispatch writing ``min(chunk, remaining)`` tokens
    from ``start`` (a shared head's end) and a decode dispatch one, the
    row's ``pinned`` pages kept. Returns ``(gaps of positions [0,
    n_written), the gap after the last dispatch's wave, the gap one more
    wave would set)``: a row whose finish lands after a wave its next
    dispatch never followed holds the last."""
    gaps = [0] * start
    ctx, gap = start, 0

    def incoming() -> int:
        return min(chunk, prompt_len - ctx) if ctx < prompt_len else 1

    while ctx < n_written:
        n = incoming()
        gap += policy.plan_eviction(ctx - gap, n, capacity, pinned) * policy.page_size
        gaps += [gap] * n
        ctx += n
    nxt = gap + policy.plan_eviction(ctx - gap, incoming(), capacity, pinned) * policy.page_size
    return gaps[:n_written], gap, nxt


def bounded_mask(torch, gaps: list[int], sink_end: int, dev):
    """[S, S] bool: query p sees key j <= p unless j lies in the evicted span
    [sink_end, sink_end + gap_p) of the gap p was computed under."""
    S = len(gaps)
    j = torch.arange(S, device=dev)[None, :]
    p = torch.arange(S, device=dev)[:, None]
    g = torch.tensor(gaps, device=dev)[:, None]
    return (j <= p) & ((j < sink_end) | (j >= sink_end + g))


def bounded_feasible(policy, prompt_lens: list[int], max_new: int, chunk: int,
                     pinned: int, start: int) -> None:
    """Host check before a run: every prompt's replayed schedule is feasible
    (``plan_eviction`` raises on a row the wave would have to fail)."""
    for n in prompt_lens:
        try:
            replay_gaps(policy, n, start, n + max_new, chunk,
                        policy.row_pages(n + max_new), pinned)
        except Exception as e:
            fail(f"bounded_kv: a {n}-token prompt is infeasible under {policy}: {e}")


# the state's page planes, [layers, pages, ...]: page 0 is the trash page
PAGE_PLANES = ("k_pages", "v_pages", "k_scales", "v_scales")


def check_graph_after_wave(torch, engine, sched) -> dict:
    """At a wave that evicted a decoding row, mid-serve: one replay of the
    decode-loop graph over the scheduler's decoding slots against the eager
    ``decode_loop_step`` on a copy of the state (tokens, context lengths,
    last tokens, gaps, table, every page but the trash page equal), then the
    state put back in place and the
    launch counts as they were (the serve goes on as if nothing ran; the
    streams are greedy, so the generator's draws do not matter)."""
    from finchat_tpu_torch.engine.engine import decode_loop_step
    from finchat_tpu_torch.ops.kernels import LAUNCHES

    torch.cuda.synchronize()
    dev = engine.device
    B = engine.engine_cfg.max_seqs
    K = engine.decode_loop_depth
    slots = sorted(sched.decoding)
    names = [n for n in ("k_pages", "v_pages", "k_scales", "v_scales", "page_table",
                         "context_lens", "last_tokens", "kv_gaps")
             if getattr(engine.state, n) is not None]
    saved = {n: getattr(engine.state, n).clone() for n in names}
    copy = _state_copy(torch, engine.state)
    before = dict(LAUNCHES)
    args = [torch.tensor(a, device=dev, dtype=dt) for a, dt in
            (([s in slots for s in range(B)], torch.bool), ([0.0] * B, torch.float32),
             ([1.0] * B, torch.float32), ([0] * B, torch.int32))]
    got = engine._loop_graph(K).replay(*args, sched.eos_id)
    _s, want = decode_loop_step(engine.params, copy, *args,
                                torch.tensor(sched.eos_id, dtype=torch.int32, device=dev),
                                config=engine.config, page_size=engine.page_size, loop_depth=K)
    torch.cuda.synchronize()
    # the trash page (page 0) is left out: every slot outside the block
    # writes it, the prefilling ones with rows of their own, in no order
    parts = {"block": bool(torch.equal(got, want))}
    for n in names:
        a, b = getattr(engine.state, n), getattr(copy, n)
        parts[n] = bool(torch.equal(a[:, 1:], b[:, 1:]) if n in PAGE_PLANES else torch.equal(a, b))
    same = all(parts.values())
    gaps = [int(x) for x in engine.state.kv_gaps[slots].tolist()]
    for n in names:
        getattr(engine.state, n).copy_(saved[n])
    LAUNCHES.clear()
    LAUNCHES.update(before)
    del saved, copy
    torch.cuda.synchronize()
    log(f"    decode-loop graph (after a wave): a replayed block of {K} over slots {slots} "
        f"(gaps {gaps}) equals the eager loop on a copy of the state: {same} {parts}")
    if not same:
        fail("bounded_kv: after an eviction wave the decode-loop graph disagrees with the "
             "eager decode_loop_step")
    return dict(equal=same, slots=slots, gaps=gaps)


def profile_bounded_step(torch, engine, context: int, active: int) -> dict:
    """A bounded decode step against an unbounded one on the same engine:
    ``active`` slots at ``context`` absolute tokens, unbounded (every page,
    gap 0) and bounded (the budget's pages, the gap that compacts the
    context into them), each measured by ``_profile_call``."""
    B = engine.engine_cfg.max_seqs
    page = engine.page_size
    bp = engine.bounded_kv
    act = [s < active for s in range(B)]
    zeros, ones, izeros = [0.0] * B, [1.0] * B, [0] * B
    full = -(-(context + 8) // page)
    gap = max(0, -(-(context + 8 - bp.budget_pages * page) // page)) * page
    out = {}
    for name, per, g in (("decode_step_unbounded", full, 0),
                         ("decode_step_bounded", bp.budget_pages, gap)):
        def reset(per=per, g=g):
            engine.set_page_table_rows({s: list(range(1 + s * per, 1 + (s + 1) * per))
                                        for s in range(active)})
            engine.set_context_lens_rows({s: context for s in range(active)})
            engine.set_kv_gap_rows({s: g for s in range(active)})

        p = _profile_call(torch, lambda: engine.decode(act, zeros, ones, izeros), reset)
        out[name] = dict(p, pages_a_slot=per, gap=g)
        log(f"    {name} ({active} slots at {context} tokens, {per} pages a slot, gap {g}): "
            f"{p['event_ms']:.2f} ms (CUDA events); profiled {p['profiled_window_ms']:.2f} ms, "
            f"device busy {p['device_busy_ms']:.2f} ms (idle share {p['idle_share']:.3f}): "
            f"{_by_class(p)}")
    engine.reset_slots(list(range(active)))
    return out


async def _bounded_run(torch, dev, plane: str, label: str, extras: dict, head: bool, params,
                       config, weight_gb: float, head_ids: list[int], system_prompt: str,
                       card: str) -> dict:
    """One run of ``bounded_kv``: an engine at ``EngineConfig(kv_quant=...,
    **extras)``, warmed up, 8 greedy Penny requests of 64 new tokens in two
    waves through ``LLMService`` (the system head registered first in the
    head run). Every wave is watched: a row's page list within its budget,
    the page table and ``kv_gaps`` in the storage they had, and in the
    loop run the graph held to the eager block after the first wave that
    evicted a decoding row. Then every stream is teacher-forced under the
    mask its replayed gap schedule gives, whose final gap must be the
    row's; every row evicted; the launch rules; no page left."""
    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.engine.generator import EngineGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.simple import LLMService
    from finchat_tpu_torch.utils.config import EngineConfig
    from finchat_tpu_torch.utils.metrics import METRICS

    spec = PLANES[plane]
    name = f"{plane} {label}"
    log(f"  bounded_kv {name}: EngineConfig(kv_quant={spec['kv_quant']!r}, {extras}), "
        f"system head {'registered' if head else 'not registered'}")
    gc.collect()
    torch.cuda.empty_cache()
    ecfg = EngineConfig(kv_quant=spec["kv_quant"], **extras)
    engine = InferenceEngine(config, params, ecfg, device=dev, quant=spec["quant"],
                             quant_group=spec["group"])
    bp = engine.bounded_kv
    page, chunk = engine.page_size, ecfg.prefill_chunk
    tok = ByteTokenizer()
    prompt_lens = [len(tok.encode(render_chat(system_prompt, CONTEXTS[i], [], MESSAGES[i]),
                                  add_bos=True)) for i in range(8)]
    bounded_feasible(bp, prompt_lens, AGENT_NEW, chunk, bp.sink_pages,
                     bp.sink_tokens if head else 0)
    warm = run_warmup(torch, name, engine, weight_gb)
    K = engine.decode_loop_depth
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    counts = _PlaneCounts(engine)
    handles = []
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    sched.submit = recording_submit
    watch = dict(waves=0, evicting=0, peak_rows=0, peak_held=0, moved=0, graph=None)
    table = engine.state.page_table
    wave = sched._bounded_evict_wave

    def watched_wave():
        live = list(sched.prefilling) + list(sched.decoding.values())
        gaps0 = {h.seq_id: h.kv_gap for h in live}
        ptrs = (engine.state.page_table.data_ptr(), engine.state.kv_gaps.data_ptr())
        wave()
        watch["waves"] += 1
        rows = [h for h in list(sched.prefilling) + list(sched.decoding.values())
                if h.slot >= 0 and not h.finished]
        limit = max(bp.budget_pages, max((sched._bounded_pinned_pages(h) + bp.window_pages
                                          for h in rows), default=0))
        held = sum(len(sched.allocator.owned_by(h.seq_id)) for h in rows)
        watch["peak_rows"] = max([watch["peak_rows"]] + [len(h.page_list) for h in rows])
        watch["peak_held"] = max(watch["peak_held"], held)
        if any(len(h.page_list) > limit for h in rows):
            fail(f"bounded_kv {name}: a row holds more than {limit} pages")
        if (engine.state.page_table.data_ptr(), engine.state.kv_gaps.data_ptr()) != ptrs or (
                engine.state.page_table is not table):
            watch["moved"] += 1
        if any(h.kv_gap != gaps0.get(h.seq_id, h.kv_gap) for h in rows):
            watch["evicting"] += 1
        evicted = [h for h in sched.decoding.values() if h.kv_gap != gaps0.get(h.seq_id, 0)]
        if K > 1 and evicted and watch["graph"] is None:
            watch["graph"] = check_graph_after_wave(torch, engine, sched)

    sched._bounded_evict_wave = watched_wave
    svc = LLMService(EngineGenerator(sched, tok), system_prompt,
                     SamplingParams(temperature=0.0, max_new_tokens=AGENT_NEW))
    m0 = METRICS.snapshot()
    reset_launches()
    if head:
        shared = sched.register_prefix(head_ids)
        if shared != bp.sink_tokens:
            fail(f"bounded_kv {name}: the head registered {shared} tokens, not the sink's "
                 f"{bp.sink_tokens}")
    await sched.start()

    async def one(i: int) -> None:
        async for _chunk in svc.process_message(MESSAGES[i], context=CONTEXTS[i],
                                                conversation_id=f"bkv-{i}"):
            pass

    t0 = time.perf_counter()
    wave1 = [asyncio.create_task(one(i)) for i in range(4)]
    while not any(h.generated > 0 for h in handles):
        await asyncio.sleep(0.005)
    wave2 = [asyncio.create_task(one(i)) for i in range(4, 8)]
    await asyncio.gather(*wave1, *wave2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    await sched.stop()
    sched.submit = submit
    sched._bounded_evict_wave = wave
    launches = dict(LAUNCHES)
    calls = dict(counts.calls)
    counts.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(handles) != 8 or not all(h.finished and h.generated > 0 for h in handles):
        fail(f"bounded_kv {name}: not every request completed with tokens")
    if not all(h.generated == AGENT_NEW or h.history[-1] == tok.eos_id for h in handles):
        fail(f"bounded_kv {name}: a request ended before max_new_tokens without EOS")
    check_plane_launches(name, spec, config, launches, calls, K, 1)
    m = lambda k: _metric_delta(METRICS, m0, k)  # noqa: E731
    evicted = m("finchat_boundedkv_evicted_pages_total")
    gaps = {h.conversation_id: h.kv_gap for h in handles}
    log(f"    {name}: {watch['waves']} waves, {watch['evicting']} evicted; "
        f"{evicted:.0f} pages evicted; final gaps {gaps}; peak {watch['peak_rows']} pages a "
        f"row, {watch['peak_held']} held by the rows at once; table or gaps rebound "
        f"{watch['moved']} times")
    if evicted <= 0 or not all(g > 0 for g in gaps.values()):
        fail(f"bounded_kv {name}: a row never evicted (evicted pages {evicted}, gaps {gaps})")
    if watch["moved"]:
        fail(f"bounded_kv {name}: a wave rebound state.page_table or state.kv_gaps")
    if K > 1 and (watch["graph"] is None or calls["decode_loop"] < 1):
        fail(f"bounded_kv {name}: no decode-loop block ran across a wave")
    if head and m("finchat_prefix_hits_total") != 8:
        fail(f"bounded_kv {name}: {m('finchat_prefix_hits_total')} prefix hits, not 8")
    checks = []
    for h in handles:
        n_prompt, served = len(h.prompt_ids), h.generated
        written = n_prompt + served - 1
        if not written <= h.kv_ctx <= written + 1:
            fail(f"bounded_kv {name}: {h.seq_id}'s kv_ctx {h.kv_ctx} against {written} written")
        pinned = max(bp.sink_pages, h.shared_len // page)
        replayed, final, nxt = replay_gaps(bp, n_prompt, h.shared_len, h.kv_ctx, chunk,
                                           bp.row_pages(n_prompt + AGENT_NEW), pinned)
        if h.kv_gap not in (final, nxt):
            fail(f"bounded_kv {name}: {h.seq_id}'s gap {h.kv_gap}, the replay's {final} "
                 f"(or {nxt} after one more wave)")
        visible = bounded_mask(torch, replayed[:written], pinned * page, dev)
        c = teacher_forced_check(torch, params, config, h, spec["kv_quant"], visible=visible)
        c.update(kv_gap=h.kv_gap, replayed_gap=final, prompt=n_prompt)
        checks.append(c)
        del visible
    decode_tokens = sum(h.generated - 1 for h in handles)
    t_first = min(h.first_token_at for h in handles)
    t_last = max(h.last_token_at for h in handles)
    agg = decode_tokens / max(t_last - t_first, 1e-9)
    per_stream = statistics.median((h.generated - 1) / max(h.last_token_at - h.first_token_at,
                                                           1e-9) for h in handles)
    ttft = statistics.median(h.first_token_at - h.submitted_at for h in handles)
    out = dict(label=label, config=extras, head=head, warmup=warm, wall_s=wall, ttft_p50_s=ttft,
               decode_tokens_per_s=agg, decode_tokens_per_s_per_stream=per_stream,
               calls=calls, peak_gb=peak_gb, pages_evicted=evicted,
               peak_pages_a_row=watch["peak_rows"], peak_pages_held=watch["peak_held"],
               waves=watch["waves"], evicting_waves=watch["evicting"], final_gaps=gaps,
               graph_after_wave=watch["graph"], teacher_forced=checks,
               bounded_sessions=m("finchat_boundedkv_bounded_sessions_total"),
               recompute_fallbacks=m("finchat_boundedkv_recompute_fallbacks_total"),
               launches={k: v for k, v in launches.items() if v})
    if label == "depth1" and plane == "bf16":
        out["profile"] = profile_bounded_step(torch, engine, context=max(prompt_lens),
                                              active=8)
    log(f"    {name}: {len(handles)} requests in {wall:.2f} s; TTFT p50 {ttft:.3f} s; decode "
        f"{agg:.1f} tokens/s aggregate, {per_stream:.1f} per stream; pages held at peak "
        f"{watch['peak_held']} ({watch['peak_rows']} a row), {evicted:.0f} evicted; peak "
        f"{peak_gb:.2f} GB ({card})")
    sched.retire_prefixes()
    if sched.allocator.used_count:
        fail(f"bounded_kv {name}: {sched.allocator.used_count} pages left allocated")
    del engine, sched, svc, recording_submit, submit, counts
    gc.collect()
    torch.cuda.empty_cache()
    return out


async def bounded_kv(torch, dev, card: str) -> dict:
    """Bounded KV at ``llama3-8b`` full width over ``PLANE_DEPTH`` of its
    layers, random weights from a seeded generator, greedy (``BOUNDED_RUNS``): bf16 at depth 1, at
    ``decode_loop_depth=4`` (the graph replaying across eviction waves) and
    with the system head registered; int8+kv8 at depth 1 (K4, K5, K6 and K8
    with gaps). Each run's launches are a window of their own."""
    import dataclasses

    from finchat_tpu_torch.models.llama import PRESETS, init_params
    from finchat_tpu_torch.models.quant import init_quantized_params
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat_head

    config = dataclasses.replace(PRESETS["llama3-8b"], n_layers=PLANE_DEPTH)
    system_prompt = (REPO / "prompts" / "system_prompt.txt").read_text()
    head_ids = ByteTokenizer().encode(render_chat_head(system_prompt), add_bos=True)[:-1]
    t0 = time.perf_counter()
    out = {}
    for plane in dict.fromkeys(p for p, *_r in BOUNDED_RUNS):
        spec = PLANES[plane]
        _free(torch)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        base = torch.cuda.memory_allocated()
        if spec["quant"]:
            params = init_quantized_params(config, gen, dev, mode=spec["quant"],
                                           group_size=spec["group"])
        else:
            params = init_params(config, gen, dev)
        torch.cuda.synchronize()
        weight_gb = (torch.cuda.memory_allocated() - base) / 1e9
        for p, label, extras, head in BOUNDED_RUNS:
            if p == plane:
                out[f"{plane} {label}"] = await _bounded_run(
                    torch, dev, plane, label, extras, head, params, config, weight_gb,
                    head_ids, system_prompt, card)
        del params
        _free(torch)
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# phase 6: train
# --------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 1, 2048
# K7's kernels, counted in the train phase: the Hopper forward (the bf16
# prefill body's contiguous entry), the older forward, the older backward,
# the Hopper backward
K7_KERNELS = ("flash_attention_sm90", "flash_attention", "flash_attention_bwd",
              "flash_attention_bwd_sm90")


# --------------------------------------------------------------------------
# the serving-app phases' bookkeeping (fleet_phase, fabric_phase, pod_phase)
# --------------------------------------------------------------------------

PLANE_WAIT_S = 300.0


def _record_submits(reps, handles: list, delivered: dict, n_prompt: dict) -> dict:
    """Wrap each replica's ``scheduler.submit`` (``reps``: replica id ->
    scheduler) so every submission lands in ``handles`` as (replica id,
    handle), the token ids its consumer was handed in ``delivered`` and its
    prompt's length at its first token in ``n_prompt`` (a partial hold's
    prompt grows at the graft). Returns the real submits, to put back."""
    real = {}
    for rid, sched in reps.items():
        submit = sched.submit

        async def recording(*a, _submit=submit, _rid=rid, **k):
            h = await _submit(*a, **k)
            handles.append((_rid, h))
            put, seen = h.events.put_nowait, delivered.setdefault(id(h), [])

            def put_recorded(ev, _put=put, _seen=seen, _h=h):
                if ev.get("type") == "token":
                    if not _seen:
                        n_prompt[id(_h)] = len(_h.history) - 1
                    _seen.append(ev["token_id"])
                _put(ev)

            h.events.put_nowait = put_recorded
            return h

        real[rid] = submit
        sched.submit = recording
    return real


class _Turns:
    """Kafka traffic of a phase: a producer, a watcher of ``ai_response``,
    the payloads by message id and the complete markers seen."""

    def __init__(self, broker, store, prefix: str):
        from finchat_tpu_torch.io.kafka import KafkaClient
        from finchat_tpu_torch.utils.config import AI_RESPONSE_TOPIC, KafkaConfig

        self.store, self.prefix = store, prefix
        self.watcher = KafkaClient(KafkaConfig(), broker=broker)
        self.watcher.setup_consumer(topics=[AI_RESPONSE_TOPIC])
        self.producer = KafkaClient(KafkaConfig(), broker=broker)
        self.outbound: list = []
        self.payloads: dict = {}
        self.users: dict = {}

    def add_conversation(self, conv: str, k: int, history: int) -> None:
        self.users[conv] = f"user-app-{k % APP_CONVS}"
        self.store.upsert_context(conv, _app_context(k % APP_CONVS))
        t_hist = int(time.time()) - 3600
        for j in range(history):
            self.store.add_user_message(
                conv, f"Earlier question {j}: how much did I spend on groceries and dining out "
                f"in week {j}, and is that more than my plan allows?", self.users[conv],
                timestamp=t_hist)

    def produce(self, conv: str, mid: str, payload: dict | None = None) -> None:
        """One user message (or, with ``payload``, that message again: a
        redelivery)."""
        from finchat_tpu_torch.utils.config import USER_MESSAGE_TOPIC

        if payload is None:
            payload = {"message": MESSAGES[len(self.payloads) % len(MESSAGES)],
                       "conversation_id": conv, "user_id": self.users[conv], "message_id": mid}
            self.store.add_user_message(conv, payload["message"], payload["user_id"])
            self.payloads[mid] = payload
        self.producer.produce_message(USER_MESSAGE_TOPIC, conv, payload)

    def completes(self) -> int:
        while (m := self.watcher.poll_message()) is not None:
            self.outbound.append(m.value())
        return sum(json.loads(v).get("type") == "complete" for v in self.outbound)

    async def wait(self, n: int, what: str, *apps) -> None:
        """Until ``n`` complete markers are out and no message is in flight
        on ``apps`` (its answer journaled, its offset committed)."""
        await _wait_for(lambda: self.completes() >= n and not any(a._inflight for a in apps),
                        f"{self.prefix}: {what}", PLANE_WAIT_S)

    def close(self) -> None:
        self.watcher.close()


def _of(handles, conv: str, role: str) -> list:
    """(replica id, handle) of a conversation role's submissions."""
    return [(rid, h) for rid, h in handles if h.conversation_id == f"{conv}#{role}"]


def _teacher_force_all(torch, params_of, config, handles, n_prompt: dict, vocab) -> int:
    """Every finished stream with tokens through ``teacher_forced_check``
    over everything it served (a decision under its grammar's masks);
    ``params_of(replica id)`` gives the weights it was served from."""
    from types import SimpleNamespace

    n = 0
    for rid, h in handles:
        if not (h.finished and h.generated > 0):
            continue
        decision = (h.conversation_id or "").endswith("#tool")
        whole = SimpleNamespace(seq_id=h.seq_id, history=h.history, shared_len=h.shared_len,
                                resumed_len=h.resumed_len, sampling=h.sampling,
                                prompt_ids=h.history[:n_prompt.get(id(h), len(h.prompt_ids))])
        teacher_forced_check(torch, params_of(rid), config, whole, "",
                             vocab=vocab if decision else None)
        n += 1
    return n


async def _grammar_vocab(generators):
    for gen in generators:
        task = gen._grammar_vocabs.get("tool_call")
        if task is not None:
            return await task
    return None


def _check_plane_window(what: str, spec: dict, config, launches: dict, counts: list,
                        metrics, m0: dict) -> dict:
    """The serving window's launch rules over every engine of the phase:
    every bf16 serving kernel launched, no older body."""
    from types import SimpleNamespace

    missing = [k for k in spec["kernels"] if launches[k] == 0]
    if missing:
        fail(f"{what}: kernels not launched on the phase's path: {missing}")
    decode_steps = _metric_delta(metrics, m0, "finchat_decode_dispatches_total")
    rounds = _metric_delta(metrics, m0, "finchat_mixed_dispatches_total")
    check_window("bf16", what, spec, config, launches,
                 SimpleNamespace(chunks=sum(c.chunks for c in counts)), decode_steps, rounds)
    return {k: v for k, v in launches.items() if v}


# --------------------------------------------------------------------------
# fleet_phase: three llama3-8b replicas over one weight tree, disaggregated
# --------------------------------------------------------------------------

FLEET_ROLES = "prefill,decode,decode"
FLEET_HISTORY = 6  # prior messages a conversation holds: a residue past one prefill chunk
# the session tier's RAM budget a replica: an 8B entry is 128 KiB a token, so
# EngineConfig()'s 256 MB holds no entry of over ~2k own tokens, and the
# handoff (whose wire format is the session entry) would fall back
FLEET_SESSION_BYTES = 4 << 30
FLEET_WAIT_S = 300.0
FLEET_PROBES = 6  # probes sent to the wedged replica until its breaker gives up
# the decision's token budget in the fleet, fabric and pod phases: shorter than
# the agent phases' DECISION_NEW (its grammar's budget closes the call), so the
# script stays inside its time limit; every check of those phases holds
PLANE_DECISION_NEW = 32


def plain_route(conv: str, serving: list[str], num_partitions: int) -> str:
    """The fleet's route, computed here: the conversation's CRC32 partition,
    then the serving replica whose blake2b weight for it is highest."""
    import hashlib
    import zlib

    part = str(zlib.crc32(conv.encode()) % num_partitions)

    def weight(cand: str) -> int:
        return int.from_bytes(hashlib.blake2b(f"{part}\x00{cand}".encode(),
                                              digest_size=8).digest(), "big")

    return max(sorted(serving), key=weight)


async def fleet_phase(torch, dev, card: str) -> dict:
    """The engine fleet at ``llama3-8b``'s full width, bf16: ``build_app``
    with ``fleet.replicas`` 3 and ``fleet.roles`` "prefill,decode,decode"
    (random weights from ``model.seed``, every engine at ``EngineConfig()``'s
    defaults, warmed up, the prompt heads registered on each), a stub
    retriever and an ``InMemoryBroker``; greedy sampling so every stream is
    teacher-forced.

    - One weight tree: every engine's parameter tensors are replica 0's
      (``data_ptr``), and each added replica grows device memory by its KV
      pool, not by 16 GB.
    - Routing and disaggregation: four cold Kafka turns (each conversation's
      history puts its residue past one 512-token chunk) land on the decode
      replica the router computed here picks (``plain_route``); each
      decision and response prefills on replica 0 and is imported on its
      owner (``finchat_disagg_handoffs_total``, the handoff's seconds), and
      the owner's admission resumes from the import. One more cold turn with
      replica 0 out of the pool prefills locally (``no_prefill_replica``):
      its TTFT from ingress beside the handed-off turns'.
    - Drain: a turn homed on replica 1 whose response has streamed a few
      tokens gets ``scheduler.decode`` and ``engine.rebuild`` wedged for
      replica 1: the breaker trips and drains the stream to replica 2,
      where it completes; its chunks follow the protocol and decode to its
      served tokens, which are teacher-forced.
    - Give-up and respawn: probes to replica 1 trip it until it gives up
      (OUT, two live replicas); healed, the supervisor revives it (the pool
      rebuilt on a worker thread while replica 2 serves a turn) and it is
      LIVE again with its heads; the drained conversation's next turn
      routes back to it and migrates its session bytes
      (``finchat_fleet_session_migrations_total``).

    Launch counts are set to 0 after the build and read before the drain:
    every bf16 serving kernel launched, under the serve's launch rules
    summed over the replicas, and no older body."""
    import tempfile

    import finchat_tpu_torch.serve.app as app_mod
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.fleet import LIVE, OUT
    from finchat_tpu_torch.utils import faults
    from finchat_tpu_torch.utils.config import (AI_RESPONSE_TOPIC, USER_MESSAGE_TOPIC,
                                                KafkaConfig, load_config)
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    t_phase = time.perf_counter()
    spec = PLANES["bf16"]
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="finchat-fleet-")
    cfg = load_config(overrides={
        "model.preset": "llama3-8b", "fleet.replicas": 3, "fleet.roles": FLEET_ROLES,
        "fleet.respawn_backoff_seconds": 0.2, "fleet.supervisor_interval_seconds": 0.05,
        "engine.max_new_tokens": AGENT_NEW, "engine.temperature": 0.0,
        "engine.session_cache_bytes": FLEET_SESSION_BYTES,
        "kafka.commit_after_process": True, "tracing.flight_dir": f"{tmp}/flight"})
    store = InMemoryStore()
    broker = InMemoryBroker()
    mem: list = []
    load, make = app_mod._load_model_artifacts, app_mod.make_engine_replica

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        out = load(*a, **k)
        torch.cuda.synchronize()
        mem.append(("weights", time.perf_counter() - t0, torch.cuda.memory_allocated()))
        return out

    def timed_make(*a, **k):
        t0 = time.perf_counter()
        out = make(*a, **k)
        torch.cuda.synchronize()
        mem.append((k.get("replica_id"), time.perf_counter() - t0, torch.cuda.memory_allocated()))
        return out

    app_mod._load_model_artifacts, app_mod.make_engine_replica = timed_load, timed_make
    retriever = _TurnRetriever(structured=False)
    t0 = time.perf_counter()
    try:
        app = app_mod.build_app(cfg, store=store, kafka=KafkaClient(cfg.kafka, broker=broker),
                                retriever=retriever, device=dev)
    finally:
        app_mod._load_model_artifacts, app_mod.make_engine_replica = load, make
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fleet = app.fleet
    if fleet is None or [r.role for r in fleet.replicas] != FLEET_ROLES.split(","):
        fail(f"fleet: build_app built {fleet} with roles "
             f"{None if fleet is None else [r.role for r in fleet.replicas]}")
    reps = fleet.replicas
    engines = [r.scheduler.engine for r in reps]
    config = engines[0].config
    tok = app.agent.tool_generator.tokenizer

    # --- one weight tree -------------------------------------------------
    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], tree

    ref = dict(leaves(engines[0].params))
    shared = all(dict((k, v.data_ptr()) for k, v in leaves(e.params)) ==
                 {k: v.data_ptr() for k, v in ref.items()} for e in engines[1:])
    weights_gb = (mem[0][2] - base) / 1e9
    growth = [(mem[i + 1][2] - mem[i][2]) / 1e9 for i in range(len(reps))]
    pools = [pool_bytes(e) / 1e9 for e in engines]
    memory = dict(weights_gb=weights_gb, weights_s=mem[0][1],
                  replica_growth_gb=growth, replica_pool_gb=pools,
                  replica_build_s=[m[1] for m in mem[1:]], build_s=build_s,
                  build_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    log(f"  fleet build ({card}): build_app {build_s:.1f} s; weights {weights_gb:.2f} GB in "
        f"{mem[0][1]:.1f} s; each replica (engine, warmup, scheduler) "
        + ", ".join(f"+{g:.2f} GB (pool {p:.2f} GB) in {m[1]:.1f} s"
                    for g, p, m in zip(growth, pools, mem[1:]))
        + f"; peak {memory['build_peak_gb']:.2f} GB above the {base / 1e9:.2f} GB held before; "
        f"one parameter tree: {shared} ({len(ref)} leaves)")
    if not shared:
        fail("fleet: the replicas' engines do not share one parameter tree")
    for g, p in zip(growth, pools):
        if not p <= g <= 1.1 * p + 0.5:
            fail(f"fleet: a replica grew device memory by {g:.2f} GB, its pool is {p:.2f} GB")
    for r in reps:
        if not r.registered_heads or len(r.registered_heads) != 2:
            fail(f"fleet: replica {r.replica_id} registered {len(r.registered_heads)} heads")

    # --- the drive's bookkeeping -----------------------------------------
    serving = [r.replica_id for r in reps if r.role != "prefill"]
    n_part = fleet.num_partitions
    convs, i = {"1": [], "2": []}, 0
    while len(convs["1"]) < 3 or len(convs["2"]) < 4:
        conv = f"fleet-{i}"
        convs[plain_route(conv, serving, n_part)].append(conv)
        i += 1
    # turn 1: two conversations a decode replica at once, all handed off;
    # then one handed-off turn alone and one prefilled locally alone (their
    # TTFTs compared); the drained conversation (homed on 1); a turn-1
    # conversation homed on 1 served again while 1 respawns
    turn1 = convs["1"][:2] + convs["2"][:2]
    alone_conv, local_conv = convs["2"][2], convs["2"][3]
    drained_conv, during_conv = convs["1"][2], convs["1"][0]
    cold = turn1 + [alone_conv, local_conv, drained_conv]
    history = [f"Earlier question {k}: how much did I spend on groceries and dining out in "
               f"week {k}, and is that more than my plan allows?" for k in range(FLEET_HISTORY)]
    t_hist = int(time.time()) - 3600
    for k, conv in enumerate(cold):
        store.upsert_context(conv, _app_context(k % APP_CONVS))
        for line in history:
            store.add_user_message(conv, line, f"user-app-{k % APP_CONVS}", timestamp=t_hist)
    greedy_decision = SamplingParams(temperature=0.0, max_new_tokens=PLANE_DECISION_NEW,
                                     grammar="tool_call")
    for r in reps:
        r.agent.tool_sampling = greedy_decision
    handles: list = []  # (replica id, handle) of every submission
    delivered: dict = {}  # id(handle) -> the token ids its consumer was handed
    # id(handle) -> its prompt's length at its first token (a partial hold's
    # prompt grows at the graft; a replay after a drain takes the stream so
    # far as its prompt)
    n_prompt: dict = {}
    submits = _record_submits({r.replica_id: r.scheduler for r in reps}, handles, delivered,
                              n_prompt)
    counts = {r.replica_id: _Counts(r.scheduler.engine) for r in reps}
    watcher = KafkaClient(KafkaConfig(), broker=broker)
    watcher.setup_consumer(topics=[AI_RESPONSE_TOPIC])
    producer = KafkaClient(KafkaConfig(), broker=broker)
    outbound: list = []
    payloads: dict = {}

    def drain_watcher() -> None:
        while (m := watcher.poll_message()) is not None:
            outbound.append(m.value())

    def produce(conv: str, mid: str) -> None:
        k = cold.index(conv) % APP_CONVS
        payload = {"message": MESSAGES[len(payloads) % len(MESSAGES)], "conversation_id": conv,
                   "user_id": f"user-app-{k}", "message_id": mid}
        store.add_user_message(conv, payload["message"], payload["user_id"])
        payloads[mid] = payload
        producer.produce_message(USER_MESSAGE_TOPIC, conv, payload)

    def completes() -> int:
        drain_watcher()
        return sum(json.loads(v).get("type") == "complete" for v in outbound)

    def of(conv: str, role: str) -> list:
        """The turn's own submissions (a prefill pass on replica 0 carries
        the same session key)."""
        return [(rid, h) for rid, h in handles if h.conversation_id == f"{conv}#{role}"
                and not h.seq_id.startswith("__disagg_")]

    def ttft_from_ingress(mid: str, conv: str) -> float:
        ingress = next(ev[0] for ev in TRACER.snapshot() if ev[1] == mid and ev[2] == "ingress")
        return of(conv, "resp")[-1][1].first_token_at - ingress

    def handoff_seconds(m0: dict) -> dict:
        out = {}
        for rid in serving:
            out[rid] = _seconds(METRICS, m0, f'finchat_disagg_handoff_seconds{{replica="{rid}"}}')
        return out

    m0 = METRICS.snapshot()
    reset_launches()
    TRACER.clear()
    for c in counts.values():
        c.reset()
    out: dict = {"memory": memory}
    victim = fleet._by_id["1"]
    sibling = fleet._by_id["2"]
    try:
        await app.start(serve_http=False)
        # --- turn 1: cold, handed off -------------------------------------
        t_turn = time.perf_counter()
        for k, conv in enumerate(turn1):
            produce(conv, f"fleet-m{k}")
        await _wait_for(lambda: completes() >= len(turn1), "fleet: turn 1 did not complete",
                        FLEET_WAIT_S)
        turn1_s = time.perf_counter() - t_turn
        routes = {conv: sorted({rid for rid, _h in of(conv, "tool") + of(conv, "resp")})
                  for conv in turn1}
        want_routes = {conv: [plain_route(conv, serving, n_part)] for conv in turn1}
        handoffs = {rid: _metric_delta(METRICS, m0, f'finchat_disagg_handoffs_total'
                                       f'{{replica="{rid}"}}') for rid in serving}
        passes = [h for rid, h in handles if rid == "0" and h.seq_id.startswith("__disagg_")]
        resumed = {conv: [h.resumed_len for _rid, h in of(conv, "tool") + of(conv, "resp")]
                   for conv in turn1}
        log(f"  fleet turn 1 ({card}): {len(turn1)} cold Kafka turns in {turn1_s:.2f} s; routes "
            f"{routes} (the plain router's {want_routes}); handoffs by decode replica "
            f"{handoffs}, {len(passes)} prefill passes on replica 0; resumed tokens {resumed}")
        if routes != want_routes:
            fail(f"fleet: the turns did not land where the router computed here sends them")
        if sum(handoffs.values()) < len(turn1) or len(passes) < len(turn1):
            fail(f"fleet: the cold turns were not handed off: {handoffs}, {len(passes)} passes")
        if not all(all(n > 0 for n in v) for v in resumed.values()):
            fail(f"fleet: a handed-off turn did not resume from the imported KV: {resumed}")
        ttft_turn1 = [ttft_from_ingress(f"fleet-m{k}", conv) for k, conv in enumerate(turn1)]
        # --- one cold turn alone, handed off --------------------------------
        h0 = sum(handoffs.values())
        produce(alone_conv, "fleet-alone")
        await _wait_for(lambda: completes() >= len(turn1) + 1, "fleet: the handed-off turn "
                        "alone did not complete", FLEET_WAIT_S)
        alone_handoffs = sum(_metric_delta(METRICS, m0, f'finchat_disagg_handoffs_total'
                                           f'{{replica="{rid}"}}') for rid in serving) - h0
        if alone_handoffs != 2:
            fail(f"fleet: the turn alone made {alone_handoffs} handoffs, not its decision's and "
                 "its response's")
        ttft_handed = ttft_from_ingress("fleet-alone", alone_conv)
        h0 += alone_handoffs
        # --- a cold turn prefilled locally: replica 0 out of the pool (as
        # after its give-up, which keeps it out of the pool; marking it OUT
        # would have the supervisor respawn it) --------------------------
        fb0 = METRICS.get("finchat_disagg_fallbacks_total",
                          {"replica": "2", "reason": "no_prefill_replica"})
        reps[0].scheduler.gave_up = True
        produce(local_conv, "fleet-local")
        await _wait_for(lambda: completes() >= len(turn1) + 2, "fleet: the local turn did not "
                        "complete", FLEET_WAIT_S)
        reps[0].scheduler.gave_up = False
        fallbacks = METRICS.get("finchat_disagg_fallbacks_total",
                                {"replica": "2", "reason": "no_prefill_replica"}) - fb0
        ttft_local = ttft_from_ingress("fleet-local", local_conv)
        if fallbacks < 1:
            fail("fleet: the turn with no prefill replica was not counted as a fallback")
        local_handoffs = sum(_metric_delta(METRICS, m0, f'finchat_disagg_handoffs_total'
                                           f'{{replica="{rid}"}}') for rid in serving) - h0
        if local_handoffs:
            fail(f"fleet: {local_handoffs} handoffs with replica 0 out of the pool")
        out["handoff"] = dict(handoffs=handoffs, seconds=handoff_seconds(m0), turn1_s=turn1_s,
                              ttft_turn1_s=ttft_turn1, ttft_handed_off_alone_s=ttft_handed,
                              ttft_local_alone_s=ttft_local, local_fallbacks=fallbacks)
        hs = out["handoff"]["seconds"]
        log(f"  fleet handoff ({card}): finchat_disagg_handoff_seconds "
            + ", ".join(f"replica {rid}: {v['n']} in {v['total_s']:.3f} s" for rid, v in hs.items())
            + f"; TTFT from ingress: turn 1 (four at once) p50 {statistics.median(ttft_turn1):.3f}"
            f" s; a turn alone, handed off {ttft_handed:.3f} s, prefilled locally "
            f"{ttft_local:.3f} s")

        # --- the drain ------------------------------------------------------
        d0 = METRICS.snapshot()
        produce(drained_conv, "fleet-drain")
        await _wait_for(lambda: any(h.generated >= 4 for _r, h in of(drained_conv, "resp")),
                        "fleet: the drained turn's response did not stream", FLEET_WAIT_S)
        dead = [True]

        def wedge(**ctx):
            if dead[0] and ctx.get("replica") == victim.replica_id:
                raise RuntimeError("fleet drill: replica 1 wedged")

        resp = of(drained_conv, "resp")[-1][1]
        at_arm = resp.generated
        faults.arm("scheduler.decode", wedge)
        faults.arm("engine.rebuild", wedge)
        t_arm = time.perf_counter()
        await _wait_for(lambda: resp.owner is sibling.scheduler or resp.finished,
                        "fleet: the wedged replica's stream was not drained", FLEET_WAIT_S)
        t_drained = time.perf_counter()
        at_drain = resp.generated
        await _wait_for(lambda: resp.generated > at_drain or resp.finished,
                        "fleet: the drained stream made no progress on the sibling", FLEET_WAIT_S)
        t_resumed = time.perf_counter()
        await _wait_for(lambda: completes() >= len(turn1) + 3, "fleet: the drained turn did "
                        "not complete", FLEET_WAIT_S)
        drained = _metric_delta(METRICS, d0, "finchat_fleet_drained_streams_total")
        if resp.owner is not sibling.scheduler or drained < 1:
            fail(f"fleet: the response was not drained to replica 2 ({drained} drained)")
        # --- give-up, OUT, respawn ------------------------------------------
        probes = []
        for k in range(FLEET_PROBES):
            if victim.state != LIVE:
                break
            h = await victim.scheduler.submit(f"fleet-probe{k}", list(range(40 + k, 56 + k)),
                                              SamplingParams(temperature=0.0, max_new_tokens=3))
            probes.append(h)
            await _wait_for(lambda h=h: h.finished, "fleet: a probe did not end", FLEET_WAIT_S)
        await _wait_for(lambda: victim.state != LIVE, "fleet: replica 1 did not give up",
                        FLEET_WAIT_S)
        t_out = time.perf_counter()
        live_during = METRICS.get("finchat_fleet_replicas_live")
        probe_errors = [h.seq_id for h in probes if h.generated != 3]
        dead[0] = False
        faults.disarm_all()
        t_heal = time.perf_counter()
        # a conversation homed on replica 1, rerouted to 2 while 1 respawns
        produce(during_conv, "fleet-during")
        await _wait_for(lambda: victim.state == LIVE, "fleet: replica 1 did not respawn",
                        FLEET_WAIT_S)
        t_live = time.perf_counter()
        await _wait_for(lambda: completes() >= len(turn1) + 4, "fleet: the turn served during "
                        "the respawn did not complete", FLEET_WAIT_S)
        live_after = METRICS.get("finchat_fleet_replicas_live")
        during_on = sorted({rid for rid, h in of(during_conv, "resp")
                            if h.trace_id == "fleet-during"})
        # the drained conversation's next turn routes back and migrates
        mig0 = METRICS.get("finchat_fleet_session_migrations_total")
        produce(drained_conv, "fleet-back")
        await _wait_for(lambda: completes() >= len(turn1) + 5, "fleet: the turn after the "
                        "respawn did not complete", FLEET_WAIT_S)
        migrations = METRICS.get("finchat_fleet_session_migrations_total") - mig0
        back = [(rid, h) for rid, h in of(drained_conv, "tool") + of(drained_conv, "resp")
                if h.trace_id == "fleet-back"]
        out["drill"] = dict(
            drained=drained, drain_s=t_drained - t_arm, drain_to_next_token_s=t_resumed - t_arm,
            give_up_s=t_out - t_drained, respawn_s=t_live - t_heal, live_during=live_during,
            live_after=live_after, probes=len(probes), probe_errors=probe_errors,
            served_during_respawn_on=during_on, migrations=migrations,
            back_on=sorted({rid for rid, _h in back}),
            back_resumed=[h.resumed_len for _rid, h in back],
            respawns=_metric_delta(METRICS, d0, "finchat_fleet_respawns_total"))
        dr = out["drill"]
        log(f"  fleet drill ({card}): trip to drained {dr['drain_s'] * 1e3:.1f} ms, to the next "
            f"token on replica 2 {dr['drain_to_next_token_s'] * 1e3:.1f} ms; {len(probes)} "
            f"probes to give-up ({dr['give_up_s']:.2f} s), live {live_during:.0f}; respawn "
            f"(rebuild on a worker thread, heads registered) {dr['respawn_s']:.2f} s while "
            f"{during_conv} was served on {during_on}; live {live_after:.0f}; the next turn of "
            f"{drained_conv} on {dr['back_on']}, resumed {dr['back_resumed']}, migrations "
            f"{migrations:.0f}")
        if (live_during, live_after) != (2, 3) or dr["respawns"] < 1:
            fail(f"fleet: give-up and respawn: live {live_during} then {live_after}")
        if probe_errors:
            fail(f"fleet: probes failed instead of draining: {probe_errors}")
        if during_on != ["2"]:
            fail(f"fleet: the turn during the respawn was served on {during_on}, not replica 2")
        if dr["back_on"] != ["1"] or migrations < 1 or not all(n > 0 for n in dr["back_resumed"]):
            fail(f"fleet: the turn after the respawn did not route back and resume from its "
                 f"migrated session bytes: {dr}")
        await _wait_for(lambda: not app._inflight, "fleet: a message stayed in flight")
        # the window's launches, read before the drain
        out["launches"] = _check_plane_window("fleet", spec, config, dict(LAUNCHES),
                                              list(counts.values()), METRICS, m0)
        out["prefill"] = {rid: dict(chunks=c.chunks, rows=c.rows, tokens=c.tokens)
                          for rid, c in counts.items()}
        log(f"  fleet prefill by replica (chunks, rows, tokens): "
            + ", ".join(f"{rid}: ({c.chunks}, {c.rows}, {c.tokens})" for rid, c in counts.items()))
        t_drain = time.perf_counter()
        await app.drain_and_stop()
        out["drain_and_stop_s"] = time.perf_counter() - t_drain
        drain_watcher()
    finally:
        faults.disarm_all()
        for r in reps:
            r.scheduler.submit = submits[r.replica_id]
        for c in counts.values():
            c.close()
        watcher.close()
    for r in reps:
        s = r.scheduler
        heads = sum(len(e.pages) for e in s._prefixes)
        if (s.allocator.used_count != heads or len(s.free_slots) != cfg.engine.max_seqs
                or s.decoding or s.prefilling or s.pending):
            fail(f"fleet: replica {r.replica_id} left work, a slot or a page after the drain")
    texts = _check_chunks("fleet", outbound, payloads)
    # the drained response's consumer was handed each served token once, in
    # order, across the drain, and its chunks are those tokens' text
    from finchat_tpu_torch.models.tokenizer import IncrementalDecoder

    served = resp.history[n_prompt[id(resp)]:]
    if served and served[-1] == tok.eos_id:  # a stop token ends the stream, not a token event
        served = served[:-1]
    if delivered[id(resp)] != served:
        fail(f"fleet: the drained stream's consumer got {delivered[id(resp)]}, the served "
             f"tokens are {served}")
    decoder = IncrementalDecoder(tok)
    served_text = "".join(decoder.push(t) for t in served) + decoder.flush()
    if texts["fleet-drain"] != served_text:
        fail(f"fleet: the drained turn's chunks {texts['fleet-drain']!r} are not its served "
             f"tokens' text {served_text!r}")
    vocab = await _grammar_vocab([r.generator for r in reps])
    params = engines[0].params
    # every stream but the prefill passes, over everything it served (across a
    # drain's replay too)
    served = [(rid, h) for rid, h in handles if not h.seq_id.startswith("__disagg_")]
    checked = _teacher_force_all(torch, lambda rid: params, config, served, n_prompt, vocab)
    out.update(teacher_forced=checked, drained_tokens=resp.generated,
               phase_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    del app, fleet, reps, engines, params, handles, resp, victim, sibling, probes
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  fleet ({card}): {checked} streams teacher-forced (the drained response's "
        f"{out['drained_tokens']} tokens among them); peak {out['phase_peak_gb']:.2f} GB; the "
        f"phase took {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# fabric_phase and pod_phase: the warm-state fabric over two replicas, and two
# pod hosts in one process
# --------------------------------------------------------------------------

async def fabric_phase(torch, dev, card: str) -> dict:
    """The warm-state fabric at ``llama3-8b``'s full width, bf16:
    ``build_app`` with ``fleet.replicas`` 2 (both mixed) and
    ``fabric.enabled`` at a temporary ``fabric.path`` (random weights from
    ``model.seed``, ``EngineConfig()`` but the session RAM tier, 4 GB a
    replica as in ``fleet_phase``), a stub retriever and an
    ``InMemoryBroker``; greedy, every stream teacher-forced.

    - The heads are prefilled once a fleet: replica 0's two registrations
      miss the fabric and prefill (chunks counted), replica 1's are fabric
      hits with no prefill chunk; each head's registration seconds on both.
    - Any replica resumes any conversation: two Kafka turns homed on
      replica 0 run at once; the response of one, with a follow-up, is
      submitted to replica 1, which never saw it: it resumes warm from the
      shared tier (``finchat_fabric_hits_total``,
      ``finchat_fabric_restore_seconds``), its stream equal to the same
      submission on replica 0, where the conversation lived.
    - Route-time migration: a turn homed on replica 1, then replica 1 out of
      the pool; the next turn routes to replica 0, which asks the holder
      index (``WarmFabric.holder``), moves the RAM entries, and the shared
      records stay; the turn resumes.
    - Give-up and respawn: probes to a wedged replica 1 until it gives up;
      healed, its respawn registers both heads from the fabric (two hits, no
      prefill chunk), its seconds beside PR 23's re-prefilling respawn; a
      turn homed on it then rides the restored heads.

    Launch counts are set to 0 after the build and read before the drain:
    every bf16 serving kernel launched over both replicas, no older body."""
    import tempfile

    import finchat_tpu_torch.serve.app as app_mod
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.fleet import LIVE, RESPAWNING
    from finchat_tpu_torch.utils import faults
    from finchat_tpu_torch.utils.config import load_config
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    t_phase = time.perf_counter()
    spec = PLANES["bf16"]
    _free(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="finchat-fabric-")
    cfg = load_config(overrides={
        "model.preset": "llama3-8b", "fleet.replicas": 2,
        "fleet.respawn_backoff_seconds": 0.2, "fleet.supervisor_interval_seconds": 0.05,
        "fabric.enabled": True, "fabric.path": f"{tmp}/fabric",
        "engine.max_new_tokens": AGENT_NEW, "engine.temperature": 0.0,
        "engine.session_cache_bytes": FLEET_SESSION_BYTES,
        "kafka.commit_after_process": True, "tracing.flight_dir": f"{tmp}/flight"})
    store, broker = InMemoryStore(), InMemoryBroker()

    def hits(rid: str) -> float:
        return METRICS.get("finchat_fabric_hits_total", {"replica": rid})

    # each head's registration: its seconds, its prefill chunks, a hit or not
    regs: dict = {}
    register = app_mod.register_prompt_prefixes

    def timed_register(agent, scheduler, tokenizer):
        counts, real = _Counts(scheduler.engine), scheduler.register_prefix
        rows = regs.setdefault(scheduler.replica_id, [])

        def one(ids):
            counts.reset()
            h0 = hits(scheduler.replica_id)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = real(ids)
            torch.cuda.synchronize()
            rows.append(dict(tokens=n, s=time.perf_counter() - t0, chunks=counts.chunks,
                             hit=hits(scheduler.replica_id) - h0))
            return n

        scheduler.register_prefix = one
        try:
            return register(agent, scheduler, tokenizer)
        finally:
            del scheduler.register_prefix
            counts.close()

    app_mod.register_prompt_prefixes = timed_register
    t0 = time.perf_counter()
    try:
        app = app_mod.build_app(cfg, store=store, kafka=KafkaClient(cfg.kafka, broker=broker),
                                retriever=_TurnRetriever(structured=False), device=dev)
    finally:
        app_mod.register_prompt_prefixes = register
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fleet = app.fleet
    reps = fleet.replicas if fleet is not None else []
    fabric = reps[0].scheduler.fabric if reps else None
    if len(reps) != 2 or fabric is None or reps[1].scheduler.fabric is not fabric:
        fail(f"fabric: build_app built {len(reps)} replicas over fabric {fabric}")
    engines = [r.scheduler.engine for r in reps]
    config = engines[0].config
    tok = app.agent.tool_generator.tokenizer
    out: dict = {"build_s": build_s, "memory_gb": (torch.cuda.memory_allocated() - base) / 1e9,
                 "heads": regs}
    log(f"  fabric build ({card}): build_app {build_s:.1f} s; head registrations "
        + "; ".join(f"replica {rid}: " + ", ".join(
            f"{r['tokens']} tokens in {r['s'] * 1e3:.1f} ms ({r['chunks']} prefill chunks, "
            f"hit {r['hit']:.0f})" for r in rows) for rid, rows in sorted(regs.items())))
    r0, r1 = regs.get("0", []), regs.get("1", [])
    if (len(r0) != 2 or len(r1) != 2 or any(r["hit"] or not r["chunks"] for r in r0)
            or any(r["hit"] != 1 or r["chunks"] for r in r1)
            or [r["tokens"] for r in r0] != [r["tokens"] for r in r1]):
        fail(f"fabric: the heads were not prefilled once a fleet (replica 1 from the fabric, "
             f"no prefill chunk): {regs}")

    # --- the drive's bookkeeping -----------------------------------------
    serving = [r.replica_id for r in reps]
    n_part = fleet.num_partitions
    homes: dict = {"0": [], "1": []}
    i = 0
    while len(homes["0"]) < 2 or len(homes["1"]) < 2:
        conv = f"fabric-{i}"
        homes[plain_route(conv, serving, n_part)].append(conv)
        i += 1
    (conv_a, conv_a2), (conv_b, conv_c) = homes["0"][:2], homes["1"][:2]
    turns = _Turns(broker, store, "fabric")
    for k, conv in enumerate((conv_a, conv_a2, conv_b, conv_c)):
        turns.add_conversation(conv, k, FLEET_HISTORY if k == 1 else 0)
    greedy_decision = SamplingParams(temperature=0.0, max_new_tokens=PLANE_DECISION_NEW,
                                     grammar="tool_call")
    for r in reps:
        r.agent.tool_sampling = greedy_decision
    handles: list = []
    delivered: dict = {}
    n_prompt: dict = {}
    submits = _record_submits({r.replica_id: r.scheduler for r in reps}, handles, delivered,
                              n_prompt)
    counts = {r.replica_id: _Counts(r.scheduler.engine) for r in reps}
    holder_calls = [0]
    holder = fabric.holder

    def counted_holder(key):
        holder_calls[0] += 1
        return holder(key)

    fabric.holder = counted_holder
    m0 = METRICS.snapshot()
    reset_launches()
    TRACER.clear()
    for c in counts.values():
        c.reset()
    victim = fleet._by_id["1"]
    try:
        await app.start(serve_http=False)
        # --- two turns on replica 0 at once --------------------------------
        turns.produce(conv_a, "fabric-m0")
        turns.produce(conv_a2, "fabric-m1")
        await turns.wait(2, "the turns on replica 0 did not complete", app)
        on = sorted({rid for conv in (conv_a, conv_a2) for rid, _h in
                     _of(handles, conv, "tool") + _of(handles, conv, "resp")})
        if on != ["0"]:
            fail(f"fabric: the turns homed on replica 0 ran on {on}")
        # --- a replica that never saw the conversation resumes it warm -------
        resp = _of(handles, conv_a, "resp")[-1][1]
        follow = list(resp.history) + tok.encode(" Thanks. And what about next month?")
        await asyncio.to_thread(fabric.flush)
        key = f"{conv_a}#resp"
        if reps[1].scheduler.session_cache.get(key) is not None or key not in fabric.tier:
            fail("fabric: the conversation is in replica 1's RAM, or not on the shared tier")
        f0 = METRICS.snapshot()
        h0 = hits("1")
        sampling = SamplingParams(temperature=0.0, max_new_tokens=16)
        never_seen = await _stream_ids(reps[1].scheduler, "fabric-warm-1", follow, sampling, key)
        warm_hits = hits("1") - h0
        restore = _seconds(METRICS, f0, 'finchat_fabric_restore_seconds{replica="1"}')
        where_lived = await _stream_ids(reps[0].scheduler, "fabric-warm-0", follow, sampling, key)
        out["warm_resume"] = dict(
            resumed=never_seen.resumed_len, prompt=len(follow), hits=warm_hits,
            restore=restore, ttft_s=never_seen.first_token_at - never_seen.submitted_at,
            lived_resumed=where_lived.resumed_len,
            lived_ttft_s=where_lived.first_token_at - where_lived.submitted_at)
        wr = out["warm_resume"]
        log(f"  fabric warm resume ({card}): replica 1 resumed {wr['resumed']} of "
            f"{wr['prompt']} tokens of a conversation it never saw (fabric hits {warm_hits:.0f}, "
            f"finchat_fabric_restore_seconds {restore['total_s']:.3f} s over {restore['n']}); "
            f"TTFT {wr['ttft_s']:.3f} s, on replica 0 from its RAM {wr['lived_ttft_s']:.3f} s")
        if never_seen.resumed_len <= 0 or warm_hits < 1 or restore["n"] < 1:
            fail(f"fabric: replica 1 did not resume the conversation from the fabric: {wr}")
        got = never_seen.history[len(follow):]
        want = where_lived.history[len(follow):]
        if got != want or never_seen.resumed_len != where_lived.resumed_len:
            fail(f"fabric: the resume on replica 1 served {got}, where the conversation lived "
                 f"{want}")
        # --- route-time migration by the holder index ------------------------
        turns.produce(conv_b, "fabric-m2")
        await turns.wait(3, "the turn on replica 1 did not complete", app)
        keys = [f"{conv_b}#tool", f"{conv_b}#resp"]
        held = [fabric.holder(k) for k in keys]
        victim.state = RESPAWNING  # out of the pool; the supervisor leaves it alone
        mig0, holder_calls[0] = METRICS.get("finchat_fleet_session_migrations_total"), 0
        turns.produce(conv_b, "fabric-m3")
        await turns.wait(4, "the turn after the migration did not complete", app)
        victim.state = LIVE
        await asyncio.to_thread(fabric.flush)
        back = [(rid, h) for rid, h in _of(handles, conv_b, "tool") + _of(handles, conv_b, "resp")
                if h.trace_id == "fabric-m3"]
        out["migration"] = dict(
            holders_before=held, migrations=METRICS.get("finchat_fleet_session_migrations_total")
            - mig0, holder_lookups=holder_calls[0], on=sorted({rid for rid, _h in back}),
            resumed=[h.resumed_len for _rid, h in back],
            source_ram=[victim.scheduler.session_cache.get(k) is not None for k in keys],
            shared_records=[k in fabric.tier for k in keys])
        mg = out["migration"]
        log(f"  fabric migration ({card}): holders {held}; the next turn on {mg['on']}: "
            f"{mg['migrations']:.0f} migrations by {mg['holder_lookups']} holder lookups, resumed "
            f"{mg['resumed']}; the source's RAM copies {mg['source_ram']}, the shared records "
            f"{mg['shared_records']}")
        if (any(h is None or h[0] != "1" for h in held) or mg["on"] != ["0"]
                or mg["migrations"] < 1 or mg["holder_lookups"] < 1 or any(mg["source_ram"])
                or not all(mg["shared_records"]) or not all(n > 0 for n in mg["resumed"])):
            fail(f"fabric: the migration did not go by the holder index and keep the shared "
                 f"records: {mg}")
        # --- give-up and respawn: the heads come back from the fabric ---------
        dead = [True]

        def wedge(**ctx):
            if dead[0] and ctx.get("replica") == victim.replica_id:
                raise RuntimeError("fabric drill: replica 1 wedged")

        faults.arm("scheduler.decode", wedge)
        faults.arm("engine.rebuild", wedge)
        probes = []
        for k in range(FLEET_PROBES):
            if victim.state != LIVE:
                break
            h = await victim.scheduler.submit(f"fabric-probe{k}", list(range(40 + k, 56 + k)),
                                              SamplingParams(temperature=0.0, max_new_tokens=3))
            probes.append(h)
            await _wait_for(lambda h=h: h.finished, "fabric: a probe did not end", PLANE_WAIT_S)
        await _wait_for(lambda: victim.state != LIVE, "fabric: replica 1 did not give up",
                        PLANE_WAIT_S)
        hits_before, chunks_before = hits("1"), counts["1"].chunks
        dead[0] = False
        faults.disarm_all()
        t_heal = time.perf_counter()
        await _wait_for(lambda: victim.state == LIVE, "fabric: replica 1 did not respawn",
                        PLANE_WAIT_S)
        respawn_s = time.perf_counter() - t_heal
        out["respawn"] = dict(respawn_s=respawn_s, head_hits=hits("1") - hits_before,
                              prefill_chunks=counts["1"].chunks - chunks_before,
                              heads=len(victim.registered_heads),
                              probes=len(probes))
        rs = out["respawn"]
        log(f"  fabric respawn ({card}): {len(probes)} probes to the give-up; respawn (the pool "
            f"rebuilt on a worker thread, {rs['heads']} heads from the fabric: {rs['head_hits']:.0f} "
            f"hits, {rs['prefill_chunks']} prefill chunks) {respawn_s:.2f} s (PR 23's, heads "
            f"re-prefilled: 1.10-1.21 s)")
        if rs["head_hits"] != 2 or rs["prefill_chunks"] or rs["heads"] != 2:
            fail(f"fabric: the respawn did not register both heads from the fabric: {rs}")
        turns.produce(conv_c, "fabric-m4")
        await turns.wait(5, "the turn after the respawn did not complete", app)
        after = [(rid, h) for rid, h in _of(handles, conv_c, "tool") + _of(handles, conv_c, "resp")]
        out["after_respawn"] = dict(on=sorted({rid for rid, _h in after}),
                                    shared=[h.shared_len for _rid, h in after])
        if out["after_respawn"]["on"] != ["1"] or not all(n > 0 for n in
                                                           out["after_respawn"]["shared"]):
            fail(f"fabric: the turn after the respawn did not ride the restored heads on replica "
                 f"1: {out['after_respawn']}")
        launches = dict(LAUNCHES)
        out["launches"] = _check_plane_window("fabric", spec, config, launches,
                                              list(counts.values()), METRICS, m0)
        await app.drain_and_stop()
        turns.completes()
    finally:
        faults.disarm_all()
        fabric.holder = holder
        for r in reps:
            r.scheduler.submit = submits[r.replica_id]
        for c in counts.values():
            c.close()
        turns.close()
    _check_chunks("fabric", turns.outbound, turns.payloads)
    vocab = await _grammar_vocab([r.generator for r in reps])
    params = engines[0].params
    out["teacher_forced"] = _teacher_force_all(torch, lambda rid: params, config, handles,
                                               n_prompt, vocab)
    out["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    await asyncio.to_thread(fabric.close)
    del app, fleet, reps, engines, params, handles, victim, fabric
    _free(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  fabric ({card}): {out['teacher_forced']} streams teacher-forced; peak "
        f"{out['peak_gb']:.2f} GB; the phase took {out['phase_s']:.1f} s")
    return out


class _LoopLag:
    """How late the event loop wakes a 5 ms sleeper: (wake time, lateness)
    samples, read over a window."""

    def __init__(self):
        self.samples: list = []
        self.task = None

    async def _run(self):
        while True:
            t = time.perf_counter()
            await asyncio.sleep(0.005)
            now = time.perf_counter()
            self.samples.append((now, now - t - 0.005))

    def start(self) -> None:
        self.task = asyncio.create_task(self._run())

    def max_in(self, t0: float, t1: float) -> float:
        return max((lag for t, lag in self.samples if t0 <= t <= t1 + 0.05), default=0.0)

    async def stop(self) -> None:
        self.task.cancel()
        try:
            await self.task
        except asyncio.CancelledError:
            pass


async def pod_phase(torch, dev, card: str) -> dict:
    """Two pod hosts in one process at ``llama3-8b``'s full width, bf16,
    the fabric off: host A ``build_app`` with ``fleet.replicas`` 2 (a
    one-engine app hands its ``PodCoordinator`` no fleet, so it can serve no
    pull, in the JAX package as here), host B with one engine, each its own
    weight tree from ``model.seed``; one ``InMemoryBroker`` consumer group,
    one store, one journal directory (the scenario is a host's death), and
    liaisons over ``tcp:127.0.0.1:<free port>`` both ways; greedy, every
    stream teacher-forced.

    - Host A alone serves turn 1 of three conversations at once: a short
      one, one of ``fleet_phase``'s shape (six prior messages), and one that
      stays on A's share. Host B joins the group: the first two
      conversations' partitions move to B.
    - Turn 2 of each on B pulls its session records from A over TCP before
      admission (``finchat_pod_session_pulls_total``, each record's bytes,
      ``finchat_pod_transfer_seconds``, the event loop's longest stall in
      the pull): the short one resumes warm, and each pulled stream equals
      the same submission on A, uninterrupted.
    - A is killed (its liaison off the wire, its consumer silent): B
      declares it dead after ``heartbeat_miss_threshold`` misses, evicts its
      member, adopts its partitions and replays A's journal: A's answered
      message, delivered again, is not answered twice
      (``finchat_kafka_dedupe_skips_total``). The third conversation's next
      turn, with no live peer, is a counted cold start that still answers.

    Launch counts are set to 0 after both builds and read before the
    drain: every bf16 serving kernel launched over the three engines, no
    older body."""
    import tempfile

    import finchat_tpu_torch.serve.app as app_mod
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.pod import PEER_DEAD, PEER_LIVE
    from finchat_tpu_torch.utils.config import USER_MESSAGE_TOPIC, load_config
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    t_phase = time.perf_counter()
    spec = PLANES["bf16"]
    _free(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="finchat-pod-")
    ports = {"A": _free_port(), "B": _free_port()}
    common = {"model.preset": "llama3-8b", "engine.max_new_tokens": AGENT_NEW,
              "engine.temperature": 0.0, "engine.session_cache_bytes": FLEET_SESSION_BYTES,
              "kafka.commit_after_process": True, "journal.path": f"{tmp}/journal",
              "tracing.flight_dir": f"{tmp}/flight"}
    cfgs = {h: load_config(overrides={
        **common, "fleet.replicas": 2 if h == "A" else 1, "fleet.respawn": False,
        "pod.host_id": f"host{h}", "pod.listen": f"tcp:127.0.0.1:{ports[h]}",
        "pod.peers": f"host{o}=tcp:127.0.0.1:{ports[o]}", "serve.port": _free_port()})
        for h, o in (("A", "B"), ("B", "A"))}
    store, broker = InMemoryStore(), InMemoryBroker()
    kafka = {}
    apps = {}
    memory = {}
    for h in ("A", "B"):
        kafka[h] = KafkaClient(cfgs[h].kafka, broker=broker)
        kafka[h]._member_id = f"member-host{h}"  # the assignment, fixed across runs
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        apps[h] = app_mod.build_app(cfgs[h], store=store, kafka=kafka[h],
                                    retriever=_TurnRetriever(structured=False), device=dev)
        torch.cuda.synchronize()
        memory[h] = dict(build_s=time.perf_counter() - t0,
                         device_gb=(torch.cuda.memory_allocated() - before) / 1e9)
    app_a, app_b = apps["A"], apps["B"]
    pod_a, pod_b = app_a.pod, app_b.pod
    if pod_a is None or pod_b is None or pod_a.fleet is None:
        fail(f"pod: build_app built pods {pod_a} / {pod_b}")
    scheds = {f"A{r.replica_id}": r.scheduler for r in app_a.fleet.replicas}
    scheds["B"] = app_b.scheduler
    engines = {rid: s.engine for rid, s in scheds.items()}
    config = engines["B"].config
    out: dict = {"memory": memory,
                 "total_gb": (torch.cuda.memory_allocated() - base) / 1e9}
    log(f"  pod build ({card}): host A (two replicas) {memory['A']['device_gb']:.2f} GB in "
        f"{memory['A']['build_s']:.1f} s, host B (one) {memory['B']['device_gb']:.2f} GB in "
        f"{memory['B']['build_s']:.1f} s; {out['total_gb']:.2f} GB on the card for both hosts")

    # --- which conversations move: the assignment of both members ------------
    probe = InMemoryBroker()
    members = {}
    for h in ("A", "B"):
        members[h] = KafkaClient(cfgs[h].kafka, broker=probe)
        members[h]._member_id = f"member-host{h}"
        members[h].setup_consumer(topics=[USER_MESSAGE_TOPIC])
    share = {h: {p for _t, p in c.assignment()} for h, c in members.items()}
    for c in members.values():
        c.close()
    part_of = kafka["A"].partition_for
    picked: dict = {}
    short_home = None
    for i in range(100_000):
        conv = f"pod-{i}"
        part = part_of(conv)
        if part in share["B"]:
            # both moving conversations homed on one replica of A, so their
            # turns coexist there (the ragged rounds)
            home = app_a.fleet.replica_for_partition(part).replica_id
            if "short" not in picked:
                picked["short"], short_home = conv, home
            elif "long" not in picked and home == short_home:
                picked["long"] = conv
        elif "stay" not in picked:
            picked["stay"] = conv
        if len(picked) == 3:
            break
    else:
        fail(f"pod: no conversations found for the shares {share}")
    short, long_, stay = picked["short"], picked["long"], picked["stay"]
    turns = _Turns(broker, store, "pod")
    turns.add_conversation(short, 0, 0)
    turns.add_conversation(long_, 1, FLEET_HISTORY)
    turns.add_conversation(stay, 2, 0)
    greedy_decision = SamplingParams(temperature=0.0, max_new_tokens=PLANE_DECISION_NEW,
                                     grammar="tool_call")
    for app in apps.values():
        for agent in ([r.agent for r in app.fleet.replicas] if app.fleet else [app.agent]):
            agent.tool_sampling = greedy_decision
    handles: list = []
    delivered: dict = {}
    n_prompt: dict = {}
    submits = _record_submits(scheds, handles, delivered, n_prompt)
    counts = {rid: _Counts(e) for rid, e in engines.items()}
    # A's exports: each record's key, bytes and seconds to serialize; B's pulls
    exports: list = []
    pulls: list = []
    export = pod_a.export_record
    pull_from = pod_b._pull_from

    async def timed_export(key):
        t0 = time.perf_counter()
        rec = await export(key)
        exports.append(dict(key=key, bytes=0 if rec is None else len(rec),
                            export_s=time.perf_counter() - t0))
        return rec

    async def timed_pull(peer, sched, cache, key, trace_id):
        t0 = time.perf_counter()
        ok = await pull_from(peer, sched, cache, key, trace_id)
        pulls.append(dict(key=key, t0=t0, t1=time.perf_counter(), settled=ok,
                          warm=cache.get(key) is not None))
        return ok

    pod_a.export_record, pod_b._pull_from = timed_export, timed_pull
    lag = _LoopLag()
    m0 = METRICS.snapshot()
    reset_launches()
    TRACER.clear()
    for c in counts.values():
        c.reset()
    try:
        lag.start()
        await app_a.start(serve_http=False)
        # A alone: its detector finds no host B yet
        await _wait_for(lambda: pod_a.peers["hostB"].state == PEER_DEAD,
                        "pod: host A did not find host B down", 30.0)
        # --- turn 1 of the three on A, at once -------------------------------
        for k, conv in enumerate((short, long_, stay)):
            turns.produce(conv, f"pod-m{k}")
        # quiesced before B joins: an answer whose offset is not committed yet
        # would be delivered to B again at the rebalance (the joiner replays
        # no journal; only an adopter does)
        await turns.wait(3, "turn 1 on host A did not complete", app_a)
        on_a = sorted({rid for rid, _h in handles})
        # --- B joins ---------------------------------------------------------
        await app_b.start(serve_http=False)
        await _wait_for(lambda: (pod_b.peers["hostA"].member_id is not None
                                 and pod_a.peers["hostB"].state == PEER_LIVE),
                        "pod: the hosts did not find each other", 30.0)
        got_share = {p for _t, p in kafka["B"].assignment()}
        if got_share != share["B"] or part_of(short) not in got_share \
                or part_of(long_) not in got_share or part_of(stay) in got_share:
            fail(f"pod: host B's share is {got_share}, the conversations' partitions "
                 f"{part_of(short)}, {part_of(long_)}, {part_of(stay)}")
        # --- turn 2 on B, pulled over TCP: the short one, then the long one ----
        p0 = METRICS.snapshot()
        turns.produce(short, "pod-m3")
        await turns.wait(4, "the short turn 2 on host B did not complete", app_b)
        short_pulls = list(pulls)
        turns.produce(long_, "pod-m4")
        await turns.wait(5, "the long turn 2 on host B did not complete", app_b)
        transfer = _seconds(METRICS, p0, "finchat_pod_transfer_seconds")
        cold = {r: _metric_delta(METRICS, p0, f'finchat_pod_cold_starts_total{{reason="{r}"}}')
                for r in ("breaker_open", "peer_unreachable", "transfer_corrupt",
                          "import_refused")}
        by_key = {e["key"]: e for e in exports}
        rows = []
        for p in pulls:
            e = by_key.get(p["key"], {})
            rows.append(dict(key=p["key"], bytes=e.get("bytes", 0),
                             export_s=e.get("export_s"), pull_s=p["t1"] - p["t0"],
                             warm=p["warm"], loop_stall_ms=lag.max_in(p["t0"], p["t1"]) * 1e3))
        turn2 = {conv: [(rid, h.conversation_id, h.resumed_len) for rid, h in handles
                        if h.trace_id == mid]
                 for conv, mid in ((short, "pod-m3"), (long_, "pod-m4"))}
        out["pull"] = dict(records=rows, transfer=transfer, cold_starts=cold, turn2=turn2,
                           pulls=_metric_delta(METRICS, p0, "finchat_pod_session_pulls_total"),
                           misses=_metric_delta(METRICS, p0, "finchat_pod_pull_misses_total"))
        for r in rows:
            log(f"  pod pull ({card}): {r['key']}: {r['bytes'] / 1e6:.1f} MB, serialized on A in "
                f"{(r['export_s'] or 0) * 1e3:.1f} ms, the pull {r['pull_s'] * 1e3:.1f} ms, warm "
                f"{r['warm']}, the event loop's longest stall in it {r['loop_stall_ms']:.1f} ms")
        log(f"  pod pull ({card}): finchat_pod_transfer_seconds {transfer['n']} in "
            f"{transfer['total_s']:.3f} s; cold starts {cold}; turn 2 (replica, key, resumed) "
            f"{turn2}")
        if any(rid != "B" for v in turn2.values() for rid, _k, _n in v):
            fail(f"pod: turn 2 was not served on host B: {turn2}")
        warm_short = [p for p in short_pulls if p["warm"]]
        if not warm_short or out["pull"]["pulls"] < 1:
            fail(f"pod: the short conversation was not pulled warm: {short_pulls}")
        # each pulled short stream equals the same submission on A, uninterrupted
        equal = []
        for p in warm_short:
            h = next(h for rid, h in handles if h.trace_id == "pod-m3"
                     and h.conversation_id == p["key"])
            if h.resumed_len <= 0:
                fail(f"pod: {p['key']} was pulled but resumed {h.resumed_len} tokens")
            src = next(s for rid, s in scheds.items() if rid.startswith("A")
                       and s.session_cache.get(p["key"]) is not None)
            gen = next(r.generator for r in app_a.fleet.replicas if r.scheduler is src)
            constraint = (await gen._make_constraint(h.sampling.grammar)
                          if h.sampling.grammar else None)
            ref = await src.submit(f"pod-ref-{p['key']}", list(h.prompt_ids), h.sampling,
                                   constraint=constraint, conversation_id=p["key"])
            await _wait_for(lambda ref=ref: ref.finished, "pod: the reference turn on A did "
                            "not end", PLANE_WAIT_S)
            served = h.history[len(h.prompt_ids):]
            want = ref.history[len(h.prompt_ids):]
            equal.append(dict(key=p["key"], equal=served == want, resumed=h.resumed_len,
                              ref_resumed=ref.resumed_len, tokens=len(served)))
            if served != want:
                fail(f"pod: {p['key']} pulled to B served {served}, uninterrupted on A {want}")
        out["pull"]["equal_to_a"] = equal
        # --- A dies -----------------------------------------------------------
        d0 = METRICS.snapshot()
        t_kill = time.perf_counter()
        pod_a.kill()
        app_a._consume_task.cancel()
        try:
            await app_a._consume_task
        except asyncio.CancelledError:
            pass
        app_a._consume_task = None
        await _wait_for(lambda: pod_b.peers["hostA"].state == PEER_DEAD,
                        "pod: host B did not declare host A dead", 30.0)
        t_dead = time.perf_counter()
        await _wait_for(lambda: {p for _t, p in kafka["B"].assignment()} == share["A"] | share["B"],
                        "pod: host B did not adopt host A's partitions", 10.0)
        adopted = _metric_delta(METRICS, d0, "finchat_pod_partition_adoptions_total")
        replayed = _metric_delta(METRICS, d0, "finchat_pod_adopted_ids_replayed_total")
        # A's answered turn-1 message of the staying conversation, delivered again
        s0 = METRICS.get("finchat_kafka_dedupe_skips_total")
        turns.produce(stay, "pod-m2", payload=turns.payloads["pod-m2"])
        await _wait_for(lambda: METRICS.get("finchat_kafka_dedupe_skips_total") > s0,
                        "pod: the redelivered answered message was not skipped", 30.0)
        # its next turn: no live peer, a cold start that answers
        miss0 = METRICS.get("finchat_session_cache_misses_total")
        pulls0 = METRICS.get("finchat_pod_session_pulls_total")
        turns.produce(stay, "pod-m5")
        await turns.wait(6, "the adopted conversation's turn did not complete", app_b)
        stay2 = [(rid, h.conversation_id, h.resumed_len) for rid, h in handles
                 if h.trace_id == "pod-m5"]
        out["adoption"] = dict(
            detect_s=t_dead - t_kill, adopted_partitions=adopted, replayed_ids=replayed,
            dedupe_skips=METRICS.get("finchat_kafka_dedupe_skips_total") - s0,
            answers_of_redelivered=sum(json.loads(v).get("type") == "complete" and
                                       json.loads(v).get("message_id") == "pod-m2"
                                       for v in turns.outbound),
            cold_turn=stay2, cold_pulls=METRICS.get("finchat_pod_session_pulls_total") - pulls0,
            session_misses=METRICS.get("finchat_session_cache_misses_total") - miss0)
        ad = out["adoption"]
        log(f"  pod adoption ({card}): host A declared dead {ad['detect_s']:.2f} s after the "
            f"kill; {adopted:.0f} partitions adopted, {replayed:.0f} answered ids replayed; the "
            f"redelivered answer skipped {ad['dedupe_skips']:.0f} time(s), answered "
            f"{ad['answers_of_redelivered']} time(s) in all; the adopted conversation's turn "
            f"(replica, key, resumed) {stay2}, pulls {ad['cold_pulls']:.0f}")
        if (adopted != len(share["A"]) or replayed < 1 or ad["dedupe_skips"] < 1
                or ad["answers_of_redelivered"] != 1 or ad["cold_pulls"]
                or not stay2 or any(rid != "B" or n != 0 for rid, _k, n in stay2)):
            fail(f"pod: the adoption: {ad}")
        launches = dict(LAUNCHES)
        out["launches"] = _check_plane_window("pod", spec, config, launches,
                                              list(counts.values()), METRICS, m0)
        out["turn1_on"] = on_a
        await app_b.drain_and_stop()
        await app_a.stop()
        turns.completes()
    finally:
        pod_a.export_record, pod_b._pull_from = export, pull_from
        for rid, s in scheds.items():
            s.submit = submits[rid]
        for c in counts.values():
            c.close()
        turns.close()
        await lag.stop()
    _check_chunks("pod", turns.outbound, turns.payloads)
    vocab = await _grammar_vocab([app_b.agent.tool_generator] +
                                 [r.generator for r in app_a.fleet.replicas])
    params = {rid: e.params for rid, e in engines.items()}
    out["teacher_forced"] = _teacher_force_all(torch, lambda rid: params[rid], config, handles,
                                               n_prompt, vocab)
    out["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    del apps, app_a, app_b, pod_a, pod_b, scheds, engines, params, handles
    _free(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  pod ({card}): {out['teacher_forced']} streams teacher-forced; peak "
        f"{out['peak_gb']:.2f} GB; the phase took {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# moe_phase: mixtral-8x7b, int8 weights over an int8 KV pool
# --------------------------------------------------------------------------

# the Mixtral serve: requests in two waves and their new tokens, and the
# engine's slots (its warmup runs a variant a bucket up to slots x 512 tokens,
# and every step dequantizes all 32 layers' experts: ~0.3 s a step on the
# H100, PERF.md section 5)
MOE_REQUESTS = 4
MOE_NEW = 32
MOE_SLOTS = 8
# device memory left out of the KV pool for the steps' activations (the
# largest bucket's, blocks of the expert products) and the plain forward of
# the teacher-forced check
MOE_HEADROOM_GB = 20.0


def _moe_class(name: str) -> str:
    """``_kernel_class``, with PyTorch's elementwise kernels (the experts'
    dequantization, the SiLU, the gates) a class of their own."""
    cls = _kernel_class(name)
    return "elementwise (torch)" if cls == "other" and "elementwise" in name.lower() else cls


async def moe_phase(torch, dev, card: str) -> dict:
    """``mixtral-8x7b`` at full width and depth (32 layers, 8 experts, top 2)
    on the int8+kv8 plane: int8 weights made by ``init_quantized_params``
    (each expert leaf drawn and quantized one layer's ``[E, D, F]`` slice at
    a time: a bf16 tree of 93 GB does not fit the card), the KV pool int8,
    sized to the memory left but ``MOE_HEADROOM_GB``, ``MOE_SLOTS`` slots,
    ``EngineConfig``'s defaults otherwise. Warmed up, the system head
    registered, then ``MOE_REQUESTS`` greedy requests of ``MOE_NEW`` new tokens through
    ``LLMService`` in two waves (the second once a first token streams: the
    ragged rounds run). Launches are counted from just before the
    registration to just after the serve, under the int8+kv8 plane's rules
    (``PLANES``: K4's Hopper prefill body takes every prefill chunk, the
    writer every cache write; K4's decode body, K6's Hopper body and both
    K8 bodies launch; K8's v2 and the older int8 append never). The expert
    einsums run on inline-dequantized weights, no kernel: the engine books
    them on ``finchat_quantmatmul_fallbacks_total`` (must rise), and every
    dispatch on ``finchat_quantmatmul_fused_dispatches_total`` (the backend
    gauge at 2). Every stream is teacher-forced against the plain forward
    on the same quantized tree. Prints the init seconds and peak memory
    against the tree, TTFT, the decode rate and a decode step's profile."""
    import shutil
    import tempfile

    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.engine.generator import EngineGenerator
    from finchat_tpu_torch.engine.kv_cache import page_hbm_bytes
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.llama import PRESETS, n_params
    from finchat_tpu_torch.models.quant import init_quantized_params
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat_head
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.simple import LLMService
    from finchat_tpu_torch.utils.config import EngineConfig
    from finchat_tpu_torch.utils.metrics import METRICS

    t_phase = time.perf_counter()
    plane, spec = "moe int8+kv8", PLANES["int8+kv8"]
    config = PRESETS["mixtral-8x7b"]
    _free(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_quantized_params(config, gen, dev, mode="int8")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tree = sum(t.numel() * t.element_size() for _n, t in tree_leaves(params))
    init_peak = torch.cuda.max_memory_allocated() - base
    log(f"  mixtral-8x7b: {config.n_layers} layers, {config.n_experts} experts (top "
        f"{config.top_k_experts}), {n_params(config) / 1e9:.2f} B params; the int8 tree "
        f"{tree / 2**30:.2f} GiB ({tree / 1e9:.2f} GB) on the card, random init {init_s:.1f} s, "
        f"init peak {init_peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held before "
        f"(the tree plus {(init_peak - tree) / 2**30:.2f} GiB; {card})")
    free, _total = torch.cuda.mem_get_info()
    num_pages = int((free - MOE_HEADROOM_GB * 1e9) // page_hbm_bytes(config, 128, "int8"))
    disk_dir = tempfile.mkdtemp(prefix="finchat-moe-sessions-")
    fallbacks = "finchat_quantmatmul_fallbacks_total"
    try:
        fb0 = METRICS.get(fallbacks)
        ecfg = EngineConfig(kv_quant="int8", num_pages=num_pages, max_seqs=MOE_SLOTS,
                            session_cache_disk_path=disk_dir)
        engine = InferenceEngine(config, params, ecfg, device=dev, quant="int8")
        log(f"  KV pool: {num_pages} int8 pages of 128 tokens ({pool_bytes(engine) / 2**30:.2f} "
            f"GiB; {num_pages * 128} tokens), {MOE_HEADROOM_GB:.0f} GB of the card left to the "
            "steps")
        warm = run_warmup(torch, plane, engine, tree / 1e9)
        torch.cuda.reset_peak_memory_stats()
        counts = _Counts(engine)
        tok = ByteTokenizer()
        sched = ContinuousBatchingScheduler(engine, tok.eos_id)
        handles = []
        submit = sched.submit

        async def recording_submit(*a, **k):
            h = await submit(*a, **k)
            handles.append(h)
            return h

        sched.submit = recording_submit
        system_prompt = (REPO / "prompts" / "system_prompt.txt").read_text()
        head_ids = tok.encode(render_chat_head(system_prompt), add_bos=True)[:-1]
        svc = LLMService(EngineGenerator(sched, tok), system_prompt,
                         SamplingParams(temperature=0.0, max_new_tokens=MOE_NEW))
        m0 = METRICS.snapshot()
        reset_launches()
        shared = sched.register_prefix(head_ids)
        reg_chunks = counts.chunks
        counts.reset()
        log(f"  prefix cache: the system head ({len(head_ids)} tokens) registered as {shared} "
            f"shared tokens in {reg_chunks} prefill chunks")
        if shared != (len(head_ids) // engine.page_size) * engine.page_size or not shared:
            fail(f"moe: the system head registered {shared} shared tokens")
        await sched.start()

        async def one(i: int) -> str:
            return "".join([c async for c in svc.process_message(
                MESSAGES[i], context=CONTEXTS[i], conversation_id=f"moe-{i}")])

        t_start = time.perf_counter()
        first = MOE_REQUESTS // 2
        wave1 = [asyncio.create_task(one(i)) for i in range(first)]
        while not any(h.generated > 0 for h in handles):
            await asyncio.sleep(0.005)
        wave2 = [asyncio.create_task(one(i)) for i in range(first, MOE_REQUESTS)]
        await asyncio.gather(*wave1, *wave2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        await sched.stop()
        sched.submit = submit
        launches = dict(LAUNCHES)
        prompt_lens = [len(h.prompt_ids) for h in handles]
        log(f"  served {len(handles)} requests in {wall:.2f} s; prompt tokens {prompt_lens}")
        log(f"  launches during the serve: { {k: v for k, v in launches.items() if v} }")
        if len(handles) != MOE_REQUESTS or not all(h.finished and h.generated > 0
                                                   for h in handles):
            fail("moe: not every request completed with tokens")
        if not all(h.generated == MOE_NEW or h.history[-1] == tok.eos_id for h in handles):
            fail("moe: a request ended before max_new_tokens without EOS")
        missing = [k for k in spec["kernels"] if launches[k] == 0]
        if missing:
            fail(f"moe: kernels not launched on the main path: {missing}")
        hits = _metric_delta(METRICS, m0, "finchat_prefix_hits_total")
        if hits != MOE_REQUESTS or any(h.shared_len != shared for h in handles):
            fail(f"moe: {hits:.0f} prefix hits, not {MOE_REQUESTS}")
        check_prefill_rows(plane, "moe serve", handles, counts, ecfg.prefill_chunk,
                           lambda h: h.shared_len)
        mixed = _metric_delta(METRICS, m0, "finchat_mixed_dispatches_total")
        if mixed < 1:
            fail("moe: no packed ragged round ran (prefill never coexisted with decode)")
        decode_steps = _metric_delta(METRICS, m0, "finchat_decode_dispatches_total")
        counts.chunks += reg_chunks  # the registration's chunks ran in this window too
        check_window(plane, "moe serve", spec, config, launches, counts, decode_steps, mixed)
        fb = METRICS.get(fallbacks) - fb0
        fused = _metric_delta(METRICS, m0, "finchat_quantmatmul_fused_dispatches_total")
        backend = METRICS.get("finchat_quantmatmul_backend")
        served_chunks = counts.chunks - reg_chunks  # the registration is no scheduler dispatch
        log(f"  finchat_quantmatmul_fallbacks_total +{fb:.0f} (the expert products, inline "
            f"dequantized), finchat_quantmatmul_fused_dispatches_total +{fused:.0f} (want "
            f"{decode_steps:.0f} decode steps + {mixed:.0f} ragged rounds + {served_chunks} "
            f"prefill chunks); finchat_quantmatmul_backend {backend:.0f}")
        if fb <= 0 or fused != decode_steps + mixed + served_chunks or backend != 2:
            fail(f"moe: the quantmatmul family reads fallbacks +{fb}, fused dispatches +{fused}, "
                 f"backend {backend}")
        ttfts = sorted(h.first_token_at - h.submitted_at for h in handles)
        decode_tokens = sum(h.generated - 1 for h in handles)
        t_first = min(h.first_token_at for h in handles)
        t_last = max(h.last_token_at for h in handles)
        agg_tps = decode_tokens / max(t_last - t_first, 1e-9)
        per_stream = statistics.median(
            (h.generated - 1) / max(h.last_token_at - h.first_token_at, 1e-9) for h in handles)
        log(f"  TTFT p50 {statistics.median(ttfts):.3f} s; decode {agg_tps:.2f} tokens/s "
            f"aggregate, {per_stream:.2f} per stream ({card})")
        checks = [teacher_forced_check(torch, params, config, h, "int8") for h in handles]
        sched.retire_prefixes()
        if sched.allocator.used_count != 0:
            fail(f"moe: {sched.allocator.used_count} KV pages still allocated after the serve")
        if sched.session_cache.disk is not None:
            sched.session_cache.disk.close()
        counts.close()
        steps = profile_steps(torch, engine, context=max(prompt_lens), active=MOE_REQUESTS,
                              classify=_moe_class, kinds=("decode_step",))
        peak = torch.cuda.max_memory_allocated() - base
        del engine, sched, svc, recording_submit, submit, counts, params
    finally:
        shutil.rmtree(disk_dir, ignore_errors=True)
    _free(torch)
    out = dict(init_s=init_s, tree_gib=tree / 2**30, init_peak_gib=init_peak / 2**30,
               num_pages=num_pages, warmup=warm, ttft_p50_s=statistics.median(ttfts),
               ttft_s=ttfts, decode_tokens_per_s=agg_tps,
               decode_tokens_per_s_per_stream=per_stream, wall_s=wall,
               prompt_tokens=prompt_lens, launches=launches, ragged_rounds=mixed,
               decode_steps=decode_steps, fallbacks=fb, fused_dispatches=fused,
               teacher_forced=checks, steps=steps, peak_gib=peak / 2**30)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  moe ({card}): peak {out['peak_gib']:.2f} GiB; the phase took {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# tp_phase: the mesh and tensor-parallel serving (one-rank NCCL, two gloo ranks)
# --------------------------------------------------------------------------

# new tokens a stream of the phase; (b)'s requests; the session record's next
# turn (new tokens decoded on the one-device engine)
TP_NEW = 32
TP_REQUESTS = 4
TP_NEXT_NEW = 16
TP_NEXT = "And what about next month, once rent is paid?"
# every collective and the follower's rendezvous wait at most this long
TP_TIMEOUT_S = 300.0
# llama3-8b's K8 shapes on a rank of two ([K, N]; the head's is TP_HEAD)
TP_RANK_QMM = {"q": (4096, 2048), "k_v": (4096, 512), "o": (2048, 4096),
               "gate_up": (4096, 7168), "down": (7168, 4096)}
TP_HEAD = (4096, 64128)


class _RankHeads:
    """The attention checks' head counts (``H``, ``HKV``) set to one rank's
    for the ``with`` block: llama3-8b on a rank of two holds 16 query heads
    and 4 KV heads, the same group of 4."""

    def __init__(self, h: int, hkv: int):
        self.heads = (h, hkv)

    def __enter__(self):
        global H, HKV
        self.saved = (H, HKV)
        H, HKV = self.heads

    def __exit__(self, *exc):
        global H, HKV
        H, HKV = self.saved


def _tp_params(torch, config, plane: str, dev, leaf_transform=None):
    """The phase's weights of ``plane`` from seed 0 (every rank draws the
    same tree; ``leaf_transform`` a rank's ``leaf_sharder``, which cuts each
    leaf to its slice as it is made)."""
    from finchat_tpu_torch.models.llama import init_params
    from finchat_tpu_torch.models.quant import init_quantized_params

    spec = PLANES[plane]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if spec["quant"]:
        return init_quantized_params(config, gen, dev, mode=spec["quant"],
                                     group_size=spec["group"], leaf_transform=leaf_transform)
    return init_params(config, gen, dev, leaf_transform=leaf_transform)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _name, t in tree_leaves(tree))


def _tp_follower(init_method: str, planes: tuple, device: str, queue) -> None:
    """Rank 1 of the two-rank mesh on the one card (a spawned process): its
    shard of the first plane made before it joins (while rank 0 runs the
    one-rank mesh), each leaf cut as it is made (``leaf_sharder``), then an
    engine a plane over the gloo group, following rank 0's calls; after each
    plane its launches, its weight bytes and the peak of its shard's making
    (above what it held before) go to ``queue``."""
    import dataclasses

    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist

    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.models.llama import PRESETS
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
        initialize_distributed,
        make_abstract_mesh,
    )
    from finchat_tpu_torch.parallel.ranks import RankChannel, follow
    from finchat_tpu_torch.parallel.sharding import leaf_sharder
    from finchat_tpu_torch.utils.config import EngineConfig

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    config = dataclasses.replace(PRESETS["llama3-8b"], n_layers=PLANE_DEPTH)
    me = make_abstract_mesh((1, 1, 1, 1, 2), rank=1)

    def shard(plane):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        local = _tp_params(torch, config, plane, dev, leaf_sharder(me, dev))
        torch.cuda.synchronize()
        return local, torch.cuda.max_memory_allocated(dev) - base

    local, peak = shard(planes[0])
    initialize_distributed(2, 1, backend="gloo", init_method=init_method,
                           timeout_s=TP_TIMEOUT_S, device=dev)
    try:
        mesh = build_mesh(MeshSpec(model=2), [dev, dev], "gloo")
        channel = RankChannel(mesh, TP_TIMEOUT_S)
        for plane in planes:
            if local is None:
                local, peak = shard(plane)
            spec = PLANES[plane]
            engine = InferenceEngine(config, local, EngineConfig(kv_quant=spec["kv_quant"]),
                                     quant=spec["quant"], quant_group=spec["group"], mesh=mesh)
            weight = _tree_bytes(engine.params)
            local = None
            reset_launches()
            calls = follow(engine, channel)
            torch.cuda.synchronize()
            queue.put((plane, calls, dict(LAUNCHES), weight, peak))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


async def _tp_serve(torch, engine, head_ids: list[int], system_prompt: str, n_req: int,
                    tag: str, waves: bool = False) -> dict:
    """``n_req`` greedy Penny requests of ``TP_NEW`` tokens over the
    registered head through ``LLMService``, every request queued before the
    scheduler starts (so two serves of the same engine config batch alike);
    with ``waves`` half of them, the rest once the first has a token (so
    their prefill coexists with the first wave's decode: the packed ragged
    rounds). The launches counted from the head's registration to the last
    token; ``mixed`` the ragged rounds dispatched."""
    from finchat_tpu_torch.engine.generator import EngineGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer
    from finchat_tpu_torch.ops import tp_overlap
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.simple import LLMService
    from finchat_tpu_torch.utils.metrics import METRICS

    tok = ByteTokenizer()
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    handles = []
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    sched.submit = recording_submit
    svc = LLMService(EngineGenerator(sched, tok), system_prompt,
                     SamplingParams(temperature=0.0, max_new_tokens=TP_NEW))
    reset_launches()
    tp_overlap.reset_collectives()
    sched.register_prefix(head_ids)

    async def one(i: int) -> None:
        async for _chunk in svc.process_message(MESSAGES[i], context=CONTEXTS[i],
                                                conversation_id=f"{tag}-{i}"):
            pass

    mixed0 = METRICS.get("finchat_mixed_dispatches_total")
    t0 = time.perf_counter()
    first = n_req // 2 if waves else n_req
    tasks = [asyncio.create_task(one(i)) for i in range(first)]
    for _ in range(100000):  # bounded: the submits are host work of a few ms
        if len(sched.pending) == first:
            break
        await asyncio.sleep(0.001)
    await sched.start()
    if waves:
        for _ in range(60000):  # bounded: 300 s of 5 ms ticks
            if any(h.generated > 0 for h in handles):
                break
            await asyncio.sleep(0.005)
        tasks += [asyncio.create_task(one(i)) for i in range(first, n_req)]
    await asyncio.gather(*tasks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    await sched.stop()
    sched.submit = submit
    launches = dict(LAUNCHES)
    collectives = dict(tp_overlap.COLLECTIVES)
    mixed = METRICS.get("finchat_mixed_dispatches_total") - mixed0
    if len(handles) != n_req or not all(h.finished and h.generated > 0 for h in handles):
        fail(f"tp {tag}: not every request completed with tokens")
    streams = {h.conversation_id: list(h.history[len(h.prompt_ids):]) for h in handles}
    return dict(sched=sched, handles=handles, launches=launches, collectives=collectives,
                streams=streams, wall_s=wall, mixed=mixed)


def _tp_record_turn(torch, engine, sched, h) -> tuple:
    """Conversation ``h``'s KV made again on the TP engine (its history but
    the last token prefilled into pages taken from the scheduler's
    allocator) and offloaded: every rank's heads gathered into one record of
    the one-device layout. Returns ``(record, ids)``."""
    ids = list(h.history[:-1])
    pages = sched.allocator.allocate("tp-record", -(-len(ids) // engine.page_size))
    try:
        engine.set_page_table_row(0, pages)
        engine.prefill(0, ids)
        record = engine.offload_pages(pages)
        engine.reset_slot(0)
    finally:
        sched.allocator.free("tp-record", pages)
    return record, ids


def _next_turn_on_one_device(torch, config, params, plane: str, record, ids: list[int],
                             card: str) -> dict:
    """The TP record restored into a fresh one-device engine, the next
    turn's tokens prefilled after it and ``TP_NEXT_NEW`` greedy tokens
    decoded there; the stream teacher-forced over its whole history."""
    import types

    import numpy as np

    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer
    from finchat_tpu_torch.utils.config import EngineConfig

    spec = PLANES[plane]
    engine = InferenceEngine(config, params, EngineConfig(kv_quant=spec["kv_quant"]),
                             device=params["embed"].device, quant=spec["quant"],
                             quant_group=spec["group"])
    ps, C = engine.page_size, engine.engine_cfg.prefill_chunk
    new = ByteTokenizer().encode(TP_NEXT)
    total = len(ids) + len(new) + TP_NEXT_NEW
    pages = list(range(1, 1 + -(-total // ps)))
    engine.set_page_table_row(0, pages)
    engine.restore_pages(pages[:-(-len(ids) // ps)], record)
    engine.set_context_lens_rows({0: len(ids)})
    logits = engine.prefill_chunk([new + [0] * (C - len(new))], [0], [len(ids)], [len(new)])[0]
    served = [int(engine.commit_first_token(0, logits, 0.0, 1.0, 0))]
    B = engine.engine_cfg.max_seqs
    active = np.zeros(B, bool)
    active[0] = True
    z, o, zk = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)
    for _ in range(TP_NEXT_NEW - 1):
        served.append(int(engine.decode(active, z, o, zk)[0]))
    h = types.SimpleNamespace(seq_id=f"tp {plane} next turn", prompt_ids=ids + new,
                              history=ids + new + served, shared_len=0, resumed_len=len(ids),
                              sampling=SamplingParams(temperature=0.0,
                                                      max_new_tokens=TP_NEXT_NEW))
    check = teacher_forced_check(torch, params, config, h, spec["kv_quant"])
    del engine
    _free(torch)
    return dict(resumed_tokens=len(ids), new_tokens=len(new), teacher_forced=check)


def _tp_routes(torch) -> dict:
    """The kernel each per-rank shape is routed to (llama3-8b on a rank of
    two: 16 query heads, 4 KV heads, group 4, 512-wide KV rows)."""
    from finchat_tpu_torch.ops.kv_append import append_kernel_for
    from finchat_tpu_torch.ops.paged_attention import (
        attention_kernel_for,
        decode_splits,
        ragged_kernels_for,
    )
    from finchat_tpu_torch.ops.quant_matmul import kernel_for

    group, hd = 4, 128
    qmm = {}
    for M in (64, 2048):  # a decode step's slots; a chunk of 4 x 512
        for label, (K, N) in TP_RANK_QMM.items():
            qmm[f"int8 M={M} {label} [{K}, {N}]"] = kernel_for("int8", M, K, N, K, False)
    for M in (64, 4):  # the head: a decode step's slots; a chunk's last rows
        qmm[f"int8 M={M} head [{TP_HEAD[0]}, {TP_HEAD[1]}] fp32"] = kernel_for(
            "int8", M, *TP_HEAD, TP_HEAD[0], True)
    attn = {}
    for kind in ("paged_attention", "paged_attention_q8"):
        splits, _per = decode_splits(1, MP)
        attn[f"{kind} decode"] = attention_kernel_for(kind, group, PS, splits, decode=True)
        attn[f"{kind} prefill"] = attention_kernel_for(kind, 64, PS, 1)
    for kind in ("ragged_paged_attention", "ragged_paged_attention_q8"):
        attn[f"{kind} round"] = list(ragged_kernels_for(kind, 64, PS, group))
    writer = {f"{name} rows of {4 * hd}": append_kernel_for(dtype, 4, hd)
              for name, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8))}
    return dict(quant_matmul=qmm, attention=attn, kv_write=writer)


async def tp_phase(torch, dev, card: str, results: list) -> dict:
    """The mesh and tensor-parallel serving at ``llama3-8b`` full width over
    ``PLANE_DEPTH`` layers, random weights from seed 0, greedy.

    (a) A one-rank NCCL mesh against no mesh, 8 requests of ``TP_NEW``
    tokens over the registered head, at depth 1 and at loop 4 (the loop's
    CUDA graph captures the NCCL all-reduces): the streams bit-equal, the
    launches of every kernel equal.
    (b) Two ranks on the one card over gloo (rank 1 a spawned process), bf16
    then int8+kv8, ``TP_REQUESTS`` requests in two waves at depth 1 (the
    second's prefill in packed ragged rounds with the first's decode; every
    kernel of the plane launched on both ranks): every stream
    teacher-forced against the one-device plain forward; each rank's
    launches (equal: the ranks run the same steps on their shards); a
    conversation's KV offloaded at TP=2 into one record, restored into a
    one-device engine whose next turn is teacher-forced.
    (c) Each per-rank shape's route; the weight bytes on each rank against
    the one-device tree.
    (d) Each per-rank K8 shape, and at 4 KV heads the decode and prefill
    bodies (bf16 and int8), the ragged round (the bf16 pair and the int8
    body) and the KV-row writers on 512-wide rows, against their plain
    versions, timed by the script's rules (rows of the ``kernels`` line,
    their launches rank 0's in (b)).
    No number of the phase is a TP speed: a gloo step stages through the
    host."""
    import dataclasses
    import multiprocessing as mp

    import torch.distributed as dist

    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.models.llama import PRESETS
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat_head
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
        default_backend,
        initialize_distributed,
    )
    from finchat_tpu_torch.parallel.ranks import Leader, RankChannel, rendezvous
    from finchat_tpu_torch.utils.config import EngineConfig
    from finchat_tpu_torch.utils.metrics import METRICS

    t0 = time.perf_counter()
    config = dataclasses.replace(PRESETS["llama3-8b"], n_layers=PLANE_DEPTH)
    system_prompt = (REPO / "prompts" / "system_prompt.txt").read_text()
    head_ids = ByteTokenizer().encode(render_chat_head(system_prompt), add_bos=True)[:-1]
    planes = ("bf16", "int8+kv8")
    init = rendezvous()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    follower = ctx.Process(target=_tp_follower, args=(init, planes, str(dev), queue),
                           daemon=True, name="tp-rank-1")
    follower.start()
    out: dict = {"card": card}
    try:
        _free(torch)
        params = _tp_params(torch, config, "bf16", dev)
        # (a) one rank over NCCL against no mesh
        initialize_distributed(1, 0, backend=default_backend(dev), device=dev)
        mesh1 = build_mesh(MeshSpec(model=1), [dev])
        one_rank = {}
        for depth in (1, 4):
            runs = {}
            for meshed in (False, True):
                engine = InferenceEngine(config, params, EngineConfig(decode_loop_depth=depth),
                                         device=dev, mesh=mesh1 if meshed else None)
                tag = f"tp-a{depth}{'m' if meshed else ''}"
                b0 = METRICS.get("finchat_decode_loop_blocks_total")
                r = await _tp_serve(torch, engine, head_ids, system_prompt, 8, tag)
                r["blocks"] = METRICS.get("finchat_decode_loop_blocks_total") - b0
                r["graph"] = depth in engine._loop_graphs
                r["sched"].retire_prefixes()
                runs[meshed] = r
                del engine
                _free(torch)
            plain, meshed = runs[False], runs[True]
            same = all(plain["streams"][f"tp-a{depth}-{i}"] == meshed["streams"][f"tp-a{depth}m-{i}"]
                       for i in range(8))
            moved = {k: (plain["launches"].get(k, 0), n) for k, n in meshed["launches"].items()
                     if plain["launches"].get(k, 0) != n}
            log(f"  tp (a) depth {depth}: one-rank NCCL mesh against no mesh: streams bit-equal "
                f"{same}; launches equal {not moved}; collectives issued "
                f"{meshed['collectives']}; blocks {meshed['blocks']:.0f}, graph captured "
                f"{meshed['graph']}; {meshed['wall_s']:.2f} s against {plain['wall_s']:.2f} s "
                f"({card})")
            if not same or moved:
                fail(f"tp (a) depth {depth}: the one-rank mesh parted from no mesh (streams "
                     f"equal {same}, launches that differ {moved})")
            if depth > 1 and not (meshed["graph"] and meshed["blocks"] > 0
                                  and meshed["collectives"]["row_parallel"] > 0):
                fail(f"tp (a) loop {depth}: no captured block with the mesh's collectives")
            one_rank[f"depth{depth}"] = dict(
                launches=meshed["launches"], collectives=meshed["collectives"],
                blocks=meshed["blocks"], wall_s=meshed["wall_s"], plain_wall_s=plain["wall_s"],
                tokens=sum(len(s) for s in meshed["streams"].values()))
            del runs, plain, meshed
        dist.destroy_process_group()
        out["one_rank_nccl"] = one_rank
        # (b) two gloo ranks on the one card
        initialize_distributed(2, 0, backend="gloo", init_method=init, timeout_s=TP_TIMEOUT_S,
                               device=dev)
        mesh2 = build_mesh(MeshSpec(model=2), [dev, dev], "gloo")
        channel = RankChannel(mesh2, TP_TIMEOUT_S)
        two = {}
        for plane in planes:
            spec = PLANES[plane]
            if plane != "bf16":
                del params
                _free(torch)
                params = _tp_params(torch, config, plane, dev)
            engine = InferenceEngine(config, params, EngineConfig(kv_quant=spec["kv_quant"]),
                                     device=dev, quant=spec["quant"], quant_group=spec["group"],
                                     mesh=mesh2)
            leader = Leader(engine, channel)
            try:
                r = await _tp_serve(torch, engine, head_ids, system_prompt, TP_REQUESTS,
                                    f"tp-b-{plane}", waves=True)
                record, ids = _tp_record_turn(torch, engine, r["sched"], r["handles"][0])
                r["sched"].retire_prefixes()
            finally:
                leader.stop()
            torch.cuda.synchronize()
            r["launches"] = dict(LAUNCHES)  # the serve's window and the record's turn
            f_plane, f_calls, f_launches, f_weight, f_peak = queue.get(timeout=TP_TIMEOUT_S)
            checks = [teacher_forced_check(torch, params, config, h, spec["kv_quant"])
                      for h in r["handles"]]
            mine = {k: n for k, n in r["launches"].items() if n}
            theirs = {k: n for k, n in f_launches.items() if n}
            missing = [k for k in spec["kernels"] if not mine.get(k)]
            full_bytes, rank_bytes = _tree_bytes(params), _tree_bytes(engine.params)
            # the largest whole leaf as made (bf16), and what its making may
            # hold beside the rank's shard: the leaf, and for int8 its fp32
            # copy and its int8 result while it is quantized (quant.quantize)
            leaf = max(t.numel() for _n, t in tree_leaves(params)) * 2
            load_bound = f_weight + leaf * (3.5 if spec["quant"] else 1.0) * 1.05 + (64 << 20)
            log(f"  tp (b) {plane}: {TP_REQUESTS} requests in two waves over 2 gloo ranks in "
                f"{r['wall_s']:.2f} s (host-staged: not a TP rate), {r['mixed']:.0f} packed "
                f"ragged rounds; rank 1 made {f_calls} calls; "
                f"launches rank 0 {mine}, rank 1 equal: {mine == theirs}; weights rank 0 "
                f"{rank_bytes / 1e9:.3f} GB, rank 1 {f_weight / 1e9:.3f} GB, one device "
                f"{full_bytes / 1e9:.3f} GB; rank 1's peak while making its shard leaf by leaf "
                f"{f_peak / 1e9:.3f} GB (its shard plus the largest whole leaf, {leaf / 1e9:.3f} "
                f"GB in bf16{', with its quantization' if spec['quant'] else ''}: bound "
                f"{load_bound / 1e9:.3f} GB) ({card})")
            if f_peak > load_bound:
                fail(f"tp (b) {plane}: rank 1 held {f_peak / 1e9:.3f} GB while making its shard, "
                     f"above its shard plus one whole leaf ({load_bound / 1e9:.3f} GB)")
            if f_plane != plane or mine != theirs or missing or r["mixed"] < 1:
                fail(f"tp (b) {plane}: the ranks' launches differ ({mine} against {theirs}), "
                     f"kernels were not launched ({missing}) or no packed ragged round ran "
                     f"({r['mixed']:.0f})")
            nxt = _next_turn_on_one_device(torch, config, params, plane, record, ids, card)
            log(f"  tp (b) {plane}: a conversation's record offloaded at TP=2 "
                f"({nxt['resumed_tokens']} tokens, {sum(t.numel() * t.element_size() for t in record if t is not None) / 1e6:.1f} MB) "
                f"restored into one device; its next turn teacher-forced: "
                f"{nxt['teacher_forced']}")
            two[plane] = dict(launches=r["launches"], follower_launches=f_launches,
                              follower_calls=f_calls, collectives=r["collectives"],
                              ragged_rounds=r["mixed"],
                              wall_s=r["wall_s"], teacher_forced=checks, next_turn=nxt,
                              weight_bytes=dict(rank0=rank_bytes, rank1=f_weight,
                                                one_device=full_bytes),
                              rank1_load_peak_bytes=f_peak, largest_leaf_bytes=leaf)
            del engine, leader, r, record
            _free(torch)
        del params
        dist.destroy_process_group()
        out["two_ranks_gloo"] = two
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        follower.join(timeout=60)
        if follower.is_alive():
            follower.terminate()
            follower.join(timeout=10)
            fail("tp: rank 1 did not stop")
    if follower.exitcode != 0:
        fail(f"tp: rank 1 exited with {follower.exitcode}")
    # (c) routes
    out["routes"] = _tp_routes(torch)
    log("  tp (c) routes at a rank's shapes: " + json.dumps(out["routes"]))
    # (d) the per-rank shapes against their plain versions, timed
    gen = torch.Generator(device=dev)
    gen.manual_seed(2626)
    for M in (64, 2048):
        for label, (K, N) in TP_RANK_QMM.items():
            check_qmm(torch, f"tp_int8_m{M}_{label}_{K}x{N}", gen, dev, M, K, N, "int8", 0,
                      False, results, launch_plane="tp", with_v2=False)
    check_qmm(torch, "tp_int8_m64_head_fp32", gen, dev, 64, *TP_HEAD, "int8", 0, True, results,
              launch_plane="tp", with_v2=False)
    lens = [SERVE_CONTEXT] * 8
    with _RankHeads(16, 4):
        # K1/K4's decode and prefill bodies, K3's pair and K6, the KV-row
        # writers (K2/K5) at a rank's 4 KV heads and 512-wide rows
        check_paged(torch, "tp_paged_decode_b8_kv4", gen, dev, 1, [n - 1 for n in lens], lens,
                    results, launch_plane="tp")
        check_paged(torch, "tp_paged_q8_decode_b8_kv4", gen, dev, 1, [n - 1 for n in lens],
                    lens, results, q8=True, launch_plane="tp")
        check_paged(torch, "tp_paged_prefill_q2048_kv4", gen, dev, 512, [2048] * 4, [2560] * 4,
                    results, launch_plane="tp")
        check_paged(torch, "tp_paged_q8_prefill_q1024_kv4", gen, dev, 512, [1024] * 4,
                    [1536] * 4, results, q8=True, launch_plane="tp")
        check_ragged(torch, gen, dev, results, "tp_ragged_serve_kv4", SERVE_ROUND, 2048,
                     launch_plane="tp", with_older=False)
        check_ragged(torch, gen, dev, results, "tp_ragged_q8_serve_kv4", SERVE_ROUND, 2048,
                     q8=True, launch_plane="tp", with_older=False)
        for q8 in (False, True):
            check_kv_write(torch, dev, results, q8, launch_plane="tp", prefix="tp_kv4_")
    launches = {}
    for plane in planes:
        for k, n in out["two_ranks_gloo"][plane]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    return out


def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def train_check(torch, dev) -> dict:
    """``llama3-8b`` widths at 2 layers: loss, every leaf's gradient and the
    one-shot forward's logits through K7 against the plain attention."""
    import dataclasses

    from finchat_tpu_torch.models.llama import (
        PRESETS,
        dense_causal_attention,
        forward,
        forward_full,
        init_params,
    )
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.train.train_step import named_leaves, value_and_grad

    _free(torch)
    config = dataclasses.replace(PRESETS["llama3-8b"], n_layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    params = init_params(config, gen, dev)
    tokens = torch.randint(0, config.vocab_size, (TRAIN_B, TRAIN_S), generator=gen, device=dev)
    reset_launches()
    loss_k, grads_k = value_and_grad(params, tokens, config=config)
    torch.cuda.synchronize()
    # (Hopper forward, older forward, older backward, Hopper backward): the
    # training shape's forward is the bf16 prefill body's contiguous entry,
    # its backward flash_attention_bwd_sm90
    launches = tuple(LAUNCHES[k] for k in K7_KERNELS)
    loss_p, grads_p = value_and_grad(params, tokens, config=config,
                                     attention=dense_causal_attention)
    plain = dict(named_leaves(grads_p))
    worst_leaf, worst = "", 0.0
    for path, g in named_leaves(grads_k):
        want = plain[path].float()
        rel = ((g.float() - want).norm() / want.norm().clamp(min=1e-30)).item()
        if rel >= worst:
            worst_leaf, worst = path, rel
    loss_diff = abs(loss_k.item() - loss_p.item())
    del grads_k, grads_p, plain
    for _path, leaf in named_leaves(params):
        leaf.requires_grad_(False)
    positions = torch.arange(TRAIN_S, device=dev).expand(TRAIN_B, TRAIN_S)
    with torch.no_grad():
        got = forward_full(params, tokens, positions, config=config)
        want, _ = forward(params, tokens, positions, config=config,
                          attention=dense_causal_attention)
        logit_rel = ((got - want).norm() / want.norm()).item()
        finite = bool(torch.isfinite(got).all().item())
    log(f"  2 layers at llama3-8b widths, B={TRAIN_B} S={TRAIN_S}: loss K7 {loss_k.item():.6f}, "
        f"plain {loss_p.item():.6f} (|diff| {loss_diff:.3e}, limit {TRAIN_LOSS_TOL}); worst "
        f"leaf gradient {worst_leaf} relative {worst:.3e}; one-shot forward logits relative "
        f"{logit_rel:.3e} (limits {TRAIN_REL_TOL}); K7 launches (Hopper forward, older "
        f"forward, older backward, Hopper backward) {launches}")
    if not (loss_diff <= TRAIN_LOSS_TOL and worst <= TRAIN_REL_TOL
            and logit_rel <= TRAIN_REL_TOL and finite and launches[0] > 0 and launches[1] == 0
            and launches[2] == 0 and launches[3] > 0):
        fail("train check: the K7 path disagrees with the plain attention")
    del params, got, want
    _free(torch)
    return dict(loss_k7=loss_k.item(), loss_plain=loss_p.item(), worst_leaf=worst_leaf,
                worst_leaf_rel=worst, logits_rel=logit_rel, launches=launches)


def _train_class(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n or "flash_attention_bf16_sm90" in n:
        return "K7 forward"
    if "flash_bwd" in n:  # flash_attention.cu's three kernels and the Hopper backward's
        return "K7 backward"
    if "adam" in n:
        return "optimizer"
    return "cuBLAS" if _kernel_class(name) == "matmul (cuBLAS)" else "other"


def train_full(torch, dev, card: str, steps: int = 5) -> dict:
    """Five AdamW steps of the full ``llama3-8b`` on one fixed batch, then a
    profiled sixth. Launch counts are set to 0 just before the five steps
    and read just after."""
    from torch.profiler import ProfilerActivity, profile

    from finchat_tpu_torch.models.llama import PRESETS, init_params, n_params
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.train.train_step import init_train_state, make_optimizer, make_train_step

    _free(torch)
    config = PRESETS["llama3-8b"]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(config, gen, dev)
    tokens = torch.randint(0, config.vocab_size, (TRAIN_B, TRAIN_S), generator=gen, device=dev)
    optimizer = make_optimizer()
    state = init_train_state(config, params, optimizer)
    train_step = make_train_step(config, optimizer)
    losses, times, per_step = [], [], []
    reset_launches()
    for _ in range(steps):
        before = [LAUNCHES[k] for k in K7_KERNELS]
        t0 = time.perf_counter()
        state, loss = train_step(state, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        per_step.append(tuple(LAUNCHES[k] - n for k, n in zip(K7_KERNELS, before)))
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  llama3-8b, {config.n_layers} layers, {n_params(config) / 1e9:.2f} B params, "
        f"B={TRAIN_B} S={TRAIN_S}, remat on: losses {losses}; step seconds "
        f"{[round(t, 4) for t in times]}; K7 launches per step (Hopper forward, older forward, "
        f"older backward, Hopper backward) {per_step}")
    L = config.n_layers
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"train: losses not finite and falling: {losses}")
    # remat: each layer's forward runs twice a step (again in the backward)
    if not all(step == (2 * L, 0, 0, L) for step in per_step):
        fail(f"train: K7's Hopper forward did not take every layer's forward twice a step "
             f"({2 * L}), with none of the older forward, and the Hopper backward every "
             f"layer's backward once ({L}), with none of the older backward: {per_step}")

    step_s = statistics.median(times[1:])  # step 1 also allocates moments and grads
    T = TRAIN_B * TRAIN_S
    n_matmul = n_params(config) - config.vocab_size * config.dim  # the embedding is a lookup
    pairs = TRAIN_B * TRAIN_S * (TRAIN_S + 1) // 2
    attn_flops = 3 * 4.0 * pairs * config.n_heads * config.head_dim * L  # forward + backward
    model_flops = 6.0 * n_matmul * T + attn_flops
    mfu = model_flops / step_s / BF16_FLOPS_PER_S

    w_start = torch.cuda.Event(enable_timing=True)
    w_end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w_start.record()
        state, loss = train_step(state, tokens)
        w_end.record()
        torch.cuda.synchronize()
    window_ms = w_start.elapsed_time(w_end)
    by_class, top_other = device_ms(torch, prof, _train_class, top=6)
    busy = sum(by_class.values())
    log(f"  train step: {step_s * 1e3:.1f} ms (median of steps 2-{steps}), "
        f"{T / step_s:.1f} tokens/s, model-FLOP share {mfu:.3f} of 989 TFLOP/s "
        f"(6 N T + attention, N = {n_matmul / 1e9:.2f} B matmul params), peak memory "
        f"{peak_gb:.2f} GB ({card})")
    log(f"  profiled step: window {window_ms:.1f} ms, device busy {busy:.1f} ms (idle share "
        f"{1.0 - busy / window_ms:.3f}): "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(by_class.items(), key=lambda x: -x[1]))
        + f" ({card})")
    log("  largest 'other' kernels (ms): "
        + "; ".join(f"{k} {v:.1f}" for k, v in top_other.items()))
    del state, params, prof
    _free(torch)
    return dict(losses=losses, step_s=times, median_step_s=step_s, tokens_per_s=T / step_s,
                model_flop_share=mfu, peak_gb=peak_gb, launches=launches,
                launches_per_step=per_step, profiled_window_ms=window_ms,
                device_busy_ms=busy, device_ms_by_class=by_class, top_other=top_other)


# --------------------------------------------------------------------------
# phase 6b: training over a mesh
# --------------------------------------------------------------------------

TRAIN_MESH_DEPTH = 4
TRAIN_MESH_B, TRAIN_MESH_S = 2, 1024
# two steps, for the script's clock: every check of the phase holds at two
# (the second loss below the first)
TRAIN_MESH_STEPS = 2
TRAIN_MESH_SEED = 0
# every collective, the ranks' rendezvous and each read of their results
# wait at most this long
TRAIN_MESH_TIMEOUT_S = 300.0
TRAIN_MESH_RANKS = 4
# (b) holds each step's loss within TRAIN_LOSS_TOL of the one-device step's;
# for the routed model a later step is held instead within twice the
# one-device run's own spread (if larger): the same steps with the expert
# products in blocks of this many tokens, an equally valid rounding. bf16
# AdamW's first step is sign-like (an element with a gradient at rounding
# level moves 2 lr either way) and the fp32 router turns that into other
# experts for near-tie tokens, so the trajectory moves under rounding alone
# (0.021 and 0.14 at steps 2 and 3 on the card, against 5.8e-4 at step 1)
TRAIN_MESH_SPREAD_BLOCK = 128
# the meshes of (b), one after the other over one world of four gloo ranks
# on the card: (name, axis sizes, preset, layers, B, S, n_micro or None)
TRAIN_MESHES = (
    ("data2_model2", dict(data=2, model=2), "llama3-8b", TRAIN_MESH_DEPTH, TRAIN_MESH_B,
     TRAIN_MESH_S, None),
    ("pipe2_model2", dict(pipe=2, model=2), "llama3-8b", TRAIN_MESH_DEPTH, TRAIN_MESH_B,
     TRAIN_MESH_S, 2),
    ("expert2_model2", dict(expert=2, model=2), "mixtral-8x7b", 2, 1, 512, None),
)


def _mesh_train_run(torch, dev, config, B: int, S: int, mesh=None, n_micro: int | None = None,
                    transform=None, keep_params: bool = False) -> dict:
    """``TRAIN_MESH_STEPS`` AdamW steps (default settings, remat on) from
    the weights and batch of ``TRAIN_MESH_SEED``: ``make_train_step`` with
    no mesh or over ``mesh`` (this rank's batch slice), or the pipeline's at
    ``n_micro`` (the whole batch); ``transform`` cuts each leaf as it is
    made. Launches are counted from 0 just before the steps. The losses, step
    seconds, launches, this rank's weight bytes and its peak (and with
    ``keep_params`` the parameters after the steps)."""
    from finchat_tpu_torch.models.llama import init_params
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from finchat_tpu_torch.parallel.sharding import shard_batch
    from finchat_tpu_torch.train.train_step import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_MESH_SEED)
    params = init_params(config, gen, dev, leaf_transform=transform)
    tokens = torch.randint(0, config.vocab_size, (B, S), generator=gen, device=dev)
    weight_gb = _tree_bytes(params) / 1e9
    optimizer = make_optimizer()
    state = init_train_state(config, params, optimizer)
    if n_micro:
        step = make_pipeline_train_step(config, optimizer, mesh, n_micro=n_micro)
        batch = tokens
    else:
        step = make_train_step(config, optimizer, mesh)
        batch = shard_batch(tokens, mesh) if mesh is not None else tokens
    losses, times = [], []
    reset_launches()
    for _ in range(TRAIN_MESH_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    out = dict(losses=losses, step_s=times, launches={k: n for k, n in LAUNCHES.items() if n},
               weight_gb=weight_gb, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    if keep_params:
        for _path, leaf in tree_leaves(state.params):
            leaf.grad = None
        out["params"] = state.params
    del state, params, step
    _free(torch)
    return out


def _k7_expected(layers: int, n_micro: int | None) -> dict:
    """K7's launches in ``TRAIN_MESH_STEPS`` steps of a rank running
    ``layers`` layers over ``n_micro`` microbatches: the Hopper forward
    twice a layer a microbatch (remat), the Hopper backward once, nothing
    else."""
    n = layers * (n_micro or 1) * TRAIN_MESH_STEPS
    return {"flash_attention_sm90": 2 * n, "flash_attention_bwd_sm90": n}


def _train_mesh_rank(rank: int, init_method: str, device: str, go, queue) -> None:
    """One of the four gloo ranks of (b), a spawned process on the card: its
    CUDA context made while the parent runs (a), then, once ``go`` is set,
    every mesh of ``TRAIN_MESHES`` over the same world in turn (each leaf
    cut to the rank's slice as it is made), its results to ``queue`` and
    its state freed before the next."""
    import dataclasses
    import traceback

    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from finchat_tpu_torch.models.llama import PRESETS
    from finchat_tpu_torch.parallel.mesh import MeshSpec, build_mesh, initialize_distributed
    from finchat_tpu_torch.parallel.pipeline import pipeline_shardings
    from finchat_tpu_torch.parallel.sharding import leaf_sharder

    dev = torch.device(device)
    try:
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        if not go.wait(TRAIN_MESH_TIMEOUT_S):
            raise TimeoutError("the parent never started the meshes")
        initialize_distributed(TRAIN_MESH_RANKS, rank, backend="gloo", init_method=init_method,
                               timeout_s=TRAIN_MESH_TIMEOUT_S, device=dev)
        try:
            for name, sizes, preset, depth, B, S, n_micro in TRAIN_MESHES:
                mesh = build_mesh(MeshSpec(**sizes), [dev] * TRAIN_MESH_RANKS, "gloo",
                                  timeout_s=TRAIN_MESH_TIMEOUT_S)
                config = dataclasses.replace(PRESETS[preset], n_layers=depth)
                specs = pipeline_shardings(config, mesh) if n_micro else None
                res = _mesh_train_run(torch, dev, config, B, S, mesh=mesh, n_micro=n_micro,
                                      transform=leaf_sharder(mesh, dev, specs))
                queue.put((rank, name, res))
        finally:
            dist.destroy_process_group()
    except Exception:  # the process's boundary: the parent reports it
        queue.put((rank, "error", traceback.format_exc()))


def train_mesh_phase(torch, dev, card: str, results: list) -> dict:
    """Training over a mesh: the DP x TP train step, the GPipe pipeline and
    expert-parallel MoE training, on the one card.

    (a) ``llama3-8b`` at full width over ``TRAIN_MESH_DEPTH`` layers, B=2,
    S=1024, random bf16 weights from ``TRAIN_MESH_SEED``, remat on:
    ``TRAIN_MESH_STEPS`` AdamW steps with no mesh and as many over a
    one-rank NCCL mesh from the same weights: the losses and the parameters
    after the last step bit-equal, K7's launches equal (the Hopper forward twice a layer a step,
    the Hopper backward once, nothing else). The no-mesh losses are (b)'s
    reference; then ``mixtral-8x7b`` at its published widths over 2 layers,
    B=1, S=512, as many steps on one device: the MoE reference.
    (b) Four gloo ranks on the card (spawned at the phase's start, started
    once both references are freed), three meshes over the same world in
    turn: data=2 x model=2 and pipe=2 x model=2 (n_micro=2) on (a)'s model
    and batch, expert=2 x model=2 on the Mixtral one. Every loss finite, the
    last below the first, each within ``TRAIN_LOSS_TOL`` of the one-device
    step's (a later Mixtral step within twice the one-device run's own
    spread, if larger: ``TRAIN_MESH_SPREAD_BLOCK``) and equal on every rank;
    every rank's K7 launches exact for its layers and microbatches and equal
    across ranks.
    (c) K7 forward and backward at a rank's heads (16 query, 4 KV, head dim
    128; B=1, S=1024, causal) against their plain versions, timed by the
    script's rules (rows of the ``kernels`` line, their launches rank 0's in
    (b)).
    No number of the phase is a training rate over ranks: a gloo collective
    stages through the host."""
    import dataclasses
    import multiprocessing as mp
    import queue as queue_mod

    import torch.distributed as dist

    from finchat_tpu_torch.models import llama
    from finchat_tpu_torch.models.llama import PRESETS
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from finchat_tpu_torch.parallel.ranks import rendezvous

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    queue, go = ctx.Queue(), ctx.Event()
    init = rendezvous()
    ranks = [ctx.Process(target=_train_mesh_rank, args=(r, init, str(dev), go, queue),
                         daemon=True, name=f"train-mesh-rank-{r}")
             for r in range(TRAIN_MESH_RANKS)]
    for p in ranks:
        p.start()
    out: dict = {"card": card}
    try:
        _free(torch)
        dense = dataclasses.replace(PRESETS["llama3-8b"], n_layers=TRAIN_MESH_DEPTH)
        plain = _mesh_train_run(torch, dev, dense, TRAIN_MESH_B, TRAIN_MESH_S, keep_params=True)
        mesh = build_mesh(MeshSpec(model=1), [dev])
        try:
            one = _mesh_train_run(torch, dev, dense, TRAIN_MESH_B, TRAIN_MESH_S, mesh=mesh,
                                  keep_params=True)
        finally:
            dist.destroy_process_group()
        plain_params, one_params = plain.pop("params"), one.pop("params")
        same = [path for (path, a), (_p, b) in zip(tree_leaves(plain_params),
                                                   tree_leaves(one_params))
                if torch.equal(a, b)]
        n_leaves = len(list(tree_leaves(plain_params)))
        del plain_params, one_params
        _free(torch)
        want = _k7_expected(TRAIN_MESH_DEPTH, None)
        log(f"  (a) llama3-8b, {TRAIN_MESH_DEPTH} layers, B={TRAIN_MESH_B} S={TRAIN_MESH_S}: "
            f"losses no mesh {plain['losses']}, one NCCL rank {one['losses']}; parameters "
            f"bit-equal after {TRAIN_MESH_STEPS} steps: {len(same)} of {n_leaves} leaves; "
            f"launches {plain['launches']} / {one['launches']}; step seconds "
            f"{[round(t, 4) for t in plain['step_s']]} / {[round(t, 4) for t in one['step_s']]}; "
            f"peak {plain['peak_gb']:.2f} / {one['peak_gb']:.2f} GB ({card})")
        if not (plain["losses"] == one["losses"] and len(same) == n_leaves
                and plain["launches"] == one["launches"] == want):
            fail(f"train_mesh (a): a one-rank NCCL mesh does not train bit-equal to no mesh, or "
                 f"K7's launches are not {want}")
        _n, _sizes, preset, depth, B, S, _m = TRAIN_MESHES[-1]
        moe = dataclasses.replace(PRESETS[preset], n_layers=depth)
        moe_ref = _mesh_train_run(torch, dev, moe, B, S)
        block, llama.MOE_BLOCK_TOKENS = llama.MOE_BLOCK_TOKENS, TRAIN_MESH_SPREAD_BLOCK
        try:
            moe_alt = _mesh_train_run(torch, dev, moe, B, S)
        finally:
            llama.MOE_BLOCK_TOKENS = block
        spread = [abs(a - b) for a, b in zip(moe_alt["losses"], moe_ref["losses"])]
        log(f"  (a) {preset}, {depth} layers, B={B} S={S}, one device: losses "
            f"{moe_ref['losses']}; with the experts in blocks of {TRAIN_MESH_SPREAD_BLOCK} "
            f"tokens {moe_alt['losses']} (spread {spread}); launches {moe_ref['launches']}; "
            f"step seconds {[round(t, 4) for t in moe_ref['step_s']]}; peak "
            f"{moe_ref['peak_gb']:.2f} GB ({card})")
        out["a"] = dict(no_mesh=plain, one_rank_nccl=one, moe_reference=moe_ref,
                        moe_spread=dict(losses=moe_alt["losses"], spread=spread))
        reference = {"llama3-8b": plain["losses"], preset: moe_ref["losses"]}
        limits = {"llama3-8b": [TRAIN_LOSS_TOL] * TRAIN_MESH_STEPS,
                  preset: [TRAIN_LOSS_TOL] + [max(TRAIN_LOSS_TOL, 2 * x) for x in spread[1:]]}
        _free(torch)
        out["references_s"] = time.perf_counter() - t0

        go.set()
        got: dict = {}
        for _ in range(TRAIN_MESH_RANKS * len(TRAIN_MESHES)):
            try:
                rank, name, res = queue.get(timeout=TRAIN_MESH_TIMEOUT_S)
            except queue_mod.Empty:
                fail("train_mesh (b): a rank sent no result in time")
            if name == "error":
                fail(f"train_mesh (b): rank {rank} failed:\n{res}")
            got.setdefault(name, {})[rank] = res
        for p in ranks:
            p.join(timeout=60)
        summed: dict = {r: {} for r in range(TRAIN_MESH_RANKS)}
        for name, sizes, preset, depth, B, S, n_micro in TRAIN_MESHES:
            runs = got[name]
            want = _k7_expected(depth // sizes.get("pipe", 1), n_micro)
            ref, limit = reference[preset], limits[preset]
            for rank in sorted(runs):
                r = runs[rank]
                log(f"  (b) {name} ({preset}, {depth} layers, B={B} S={S}"
                    + (f", n_micro={n_micro}" if n_micro else "") + f") rank {rank}: losses "
                    f"{r['losses']} (one device {ref}); step seconds "
                    f"{[round(t, 3) for t in r['step_s']]} (gloo stages through the host: not a "
                    f"rate); launches {r['launches']}; weights {r['weight_gb']:.3f} GB, peak "
                    f"{r['peak_gb']:.2f} GB ({card})")
                for k, n in r["launches"].items():
                    summed[rank][k] = summed[rank].get(k, 0) + n
                losses = r["losses"]
                if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                        and all(abs(a - b) <= t for a, b, t in zip(losses, ref, limit))
                        and losses == runs[0]["losses"] and r["launches"] == want):
                    fail(f"train_mesh (b) {name} rank {rank}: losses {losses} against one "
                         f"device's {ref} (limits {limit}) and rank 0's, or launches "
                         f"{r['launches']} against {want}")
        if any(summed[r] != summed[0] for r in summed):
            fail(f"train_mesh (b): the ranks' launches differ: {summed}")
        out["b"] = got
        # every kernel's count, those no rank launched at 0 (the kernels line reads them all)
        out["launches"] = {k: summed[0].get(k, 0) for k in LAUNCHES}
        out["meshes_s"] = time.perf_counter() - t0 - out["references_s"]
        log(f"  the references {out['references_s']:.1f} s, the meshes {out['meshes_s']:.1f} s "
            "(the ranks' start overlapping the references)")

        log("  (c) K7 at a rank's heads (16 query, 4 KV, head dim 128; B=1, S=1024, causal):")
        gen = torch.Generator(device=dev)
        gen.manual_seed(2727)
        with _RankHeads(16, 4):
            check_flash(torch, "flash_fwd_causal_s1024_h16", gen, dev, 1, 1024, 1024, [0], [1024],
                        results, launch_plane="train_mesh")
            check_flash(torch, "flash_bwd_causal_s1024_h16", gen, dev, 1, 1024, 1024, [0], [1024],
                        results, backward=True, launch_plane="train_mesh")
    finally:
        go.set()
        for p in ranks:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    out["seconds"] = time.perf_counter() - t0
    return out


SP_NEW = 32
SP_LONG = 7936  # the long prompt (ring bucket 8,192)
SP_HEAD, SP_TAIL = 3840, 4032  # the registered head (30 whole pages) and the prompt's tail
SP_SHORT = 64  # the stream decoding beside the long prompt
SP_RANKS = 4  # seq=2 x model=2 on the one card, over gloo
SP_TIMEOUT_S = 300.0
# gate (b) on the CPU at fp32 (a top-1 may differ only where the reference's
# top-2 margin is <= 1e-3); bf16 on the card moves logits by hundredths between
# the ring's fp32 fold and the one-device kernels (a flip at a top-2 margin of
# 0.0183 on an H100 80GB HBM3 at 700 W), so a served token is held where the
# one-device margin exceeds STREAM_MARGIN, as every stream of the script, and
# the tokens inside 1e-3 are counted
SP_MARGIN = 1e-3
# (case, plane, the engine's settings): bf16 first, then int8 weights over an
# int8 KV pool (the ranks' weights remade once)
SP_CASES = (
    ("monolithic", "bf16", dict(ring_prefill_chunk=0, mixed_step=False)),
    ("segmented", "bf16", dict(mixed_step=False)),
    ("prefix", "bf16", dict(mixed_step=False, prefix_cache=True)),
    ("ulysses", "bf16", dict(mixed_step=False, sp_mode="ulysses")),
    ("mixed", "bf16", dict(mixed_step=True)),
    ("int8", "int8+kv8", dict(mixed_step=False)),
)


def _sp_engine_cfg(plane: str, extra: dict):
    """A case's engine settings: the default ring knobs (4,096 tokens, the
    4,096-token segment), depth 1 (a gloo collective cannot be captured),
    pages for a long prompt and a short stream."""
    from finchat_tpu_torch.utils.config import EngineConfig

    kw = dict(max_seqs=4, num_pages=160, decode_loop_depth=1, prefix_cache=False,
              session_cache=False, warmup_on_start=False, kv_quant=PLANES[plane]["kv_quant"])
    return EngineConfig(**{**kw, **extra})


def _sp_config(torch):
    import dataclasses

    from finchat_tpu_torch.models.llama import PRESETS

    return dataclasses.replace(PRESETS["llama3-8b"], n_layers=PLANE_DEPTH)


def _sp_prompts() -> dict:
    """The phase's prompts, seeded token ids of the 8B vocabulary."""
    import numpy as np

    rng = np.random.default_rng(2828)
    ids = lambda n: [int(x) for x in rng.integers(1, 128_000, size=n)]  # noqa: E731
    head = ids(SP_HEAD)
    return dict(long=ids(SP_LONG), short=ids(SP_SHORT), head=head, prefixed=head + ids(SP_TAIL))


def _sp_follower(rank: int, init_method: str, device: str, queue) -> None:
    """A follower of the seq=2 x model=2 mesh on the one card (a spawned
    process): its bf16 shard made (each leaf cut as it is made) while rank 0
    runs the references, then an engine a case over the gloo group following
    rank 0's calls; after each case its calls, launches and peak go to
    ``queue`` (its int8 shard made before the int8 case)."""
    import traceback

    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist

    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
        initialize_distributed,
        make_abstract_mesh,
    )
    from finchat_tpu_torch.parallel.ranks import RankChannel, follow
    from finchat_tpu_torch.parallel.sharding import leaf_sharder

    dev = torch.device(device)
    try:
        torch.cuda.set_device(dev)
        config = _sp_config(torch)
        me = make_abstract_mesh((1, 1, 2, 1, 2), rank=rank)
        planes: dict = {"bf16": _tp_params(torch, config, "bf16", dev, leaf_sharder(me, dev))}
        initialize_distributed(SP_RANKS, rank, backend="gloo", init_method=init_method,
                               timeout_s=SP_TIMEOUT_S, device=dev)
        try:
            mesh = build_mesh(MeshSpec(seq=2, model=2), [dev] * SP_RANKS, "gloo",
                              timeout_s=SP_TIMEOUT_S)
            channel = RankChannel(mesh, SP_TIMEOUT_S)
            for name, plane, extra in SP_CASES:
                if plane not in planes:
                    planes.clear()
                    gc.collect()
                    torch.cuda.empty_cache()
                    planes[plane] = _tp_params(torch, config, plane, dev, leaf_sharder(me, dev))
                spec = PLANES[plane]
                engine = InferenceEngine(config, planes[plane], _sp_engine_cfg(plane, extra),
                                         quant=spec["quant"], quant_group=spec["group"],
                                         mesh=mesh)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_launches()
                calls = follow(engine, channel)
                torch.cuda.synchronize()
                queue.put((rank, name, dict(calls=calls, launches=dict(LAUNCHES),
                                            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                                            sp_mode=engine.sp_mode)))
                del engine
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    except Exception:  # the process's boundary: the parent reports it
        queue.put((rank, "error", traceback.format_exc()))


def _sp_one_device(torch, config, params, plane: str, prompt: list[int]) -> dict:
    """One device's chunked prefill of ``prompt`` (no mesh): its wall,
    peak and device time by class ((c)'s yardstick)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from finchat_tpu_torch.engine.engine import InferenceEngine

    spec = PLANES[plane]
    engine = InferenceEngine(config, params, _sp_engine_cfg(plane, {}), device=params[
        "embed"].device, quant=spec["quant"], quant_group=spec["group"])
    pages = list(range(1, 1 + -(-len(prompt) // engine.page_size)))
    engine.set_page_table_row(0, pages)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.prefill(0, list(prompt))
    torch.cuda.synchronize()
    out = dict(prefill_s=time.perf_counter() - t0,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    engine.reset_slot(0)
    engine.set_page_table_row(0, pages)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.prefill(0, list(prompt))
        torch.cuda.synchronize()
    out["device_ms_by_class"], _top = device_ms(torch, prof, _sp_class)
    del engine
    _free(torch)
    return out


def _sp_teacher(torch, engine, what: str, prompt: list[int], served: list[int]) -> dict:
    """``served`` teacher-forced on one device (``engine``, no mesh): the
    prompt's chunked prefill, then each served token fed back a decode step;
    each served token must be the one-device argmax wherever that margin
    exceeds ``STREAM_MARGIN``. Returns the tokens held, those inside gate
    (b)'s 1e-3 and the margins where the two differ."""
    import numpy as np

    ps = engine.page_size
    pages = list(range(1, 1 + -(-(len(prompt) + len(served)) // ps)))
    engine.set_page_table_row(0, pages)
    rows = [engine.prefill(0, list(prompt))]
    B = engine.engine_cfg.max_seqs
    active = np.zeros(B, bool)
    active[0] = True
    z, o, zk = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)
    for tok in served[:-1]:
        engine.set_last_token(0, tok)
        _t, lg = engine.decode(active, z, o, zk, return_logits=True)
        rows.append(lg[0])
    top = torch.stack(rows).topk(2, dim=-1)
    best = top.indices[:, 0].tolist()
    margins = (top.values[:, 0] - top.values[:, 1]).tolist()
    engine.reset_slot(0)
    apart = {i: round(m, 4) for i, (t, b, m) in enumerate(zip(served, best, margins)) if t != b}
    if any(m > STREAM_MARGIN for m in apart.values()):
        fail(f"sp (b) {what}: served tokens part from one device's at margins {apart} (limit "
             f"{STREAM_MARGIN})")
    return dict(tokens=len(served), apart=apart,
                apart_past_gate_b=sum(m > SP_MARGIN for m in apart.values()))


def _sp_class(name: str) -> str:
    """The ring prefill's device time by class: the fold's fp32 products
    (cuBLAS sgemm), the model's bf16 products, our kernels, the gloo staging
    copies, and the fold's and the layers' elementwise passes."""
    n = name.lower()
    if "memcpy" in n:
        return "copies (gloo staging, host <-> device)"
    cls = _kernel_class(name)
    if cls == "matmul (cuBLAS)":
        return ("fold fp32 products (cuBLAS)" if ("f32f32" in n or "sgemm" in n) and "bf16" not in n
                else "matmul bf16 (cuBLAS)")
    return "elementwise and other" if cls == "other" else cls


async def _sp_serve(torch, engine, name: str, prompts: dict) -> dict:
    """Case ``name`` through a scheduler on rank 0: its streams, the seq-
    sharded entries it took (with the short stream's tokens at each), the
    step functions it ran (each writes the cache once a layer)."""
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.utils.metrics import METRICS

    sched = ContinuousBatchingScheduler(engine, eos_id=-1)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=SP_NEW)
    entries: list = []
    short = None
    forwarding = {e: getattr(engine, e) for e in ("prefill_ring", "prefill_ring_segment")}
    for entry, real in forwarding.items():

        def spy(*a, _real=real, _entry=entry, **k):
            entries.append((_entry, short.generated if short is not None else None))
            return _real(*a, **k)

        setattr(engine, entry, spy)
    hits = METRICS.get("finchat_prefix_hits_total")
    if name == "prefix":
        if sched.register_prefix(prompts["head"]) != SP_HEAD:
            fail("sp (b) prefix: the head was not registered whole")
    long_ids = prompts["prefixed" if name == "prefix" else "long"]

    async def tokens(h) -> list[int]:
        out = []
        while True:
            ev = await asyncio.wait_for(h.events.get(), timeout=SP_TIMEOUT_S)
            if ev["type"] == "done":
                return out
            if ev["type"] != "token":
                fail(f"sp (b) {name}: {ev}")
            out.append(ev["token_id"])

    await sched.start()
    try:
        t0 = time.perf_counter()
        out: dict = {}
        if name in ("segmented", "mixed"):
            short = await sched.submit("short", prompts["short"], greedy)
            first = await asyncio.wait_for(short.events.get(), timeout=SP_TIMEOUT_S)
            h = await sched.submit("long", long_ids, greedy)
            rest, out["long"] = await asyncio.gather(tokens(short), tokens(h))
            out["short"] = [first["token_id"]] + rest
        else:
            h = await sched.submit("long", long_ids, greedy)
            out["long"] = await tokens(h)
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["ttft_s"] = h.first_token_at - h.submitted_at
    finally:
        await sched.stop()
    sched.retire_prefixes()
    for entry, real in forwarding.items():
        setattr(engine, entry, real)
    out.update(entries=entries, ring_path=h.ring_path,
               prefix_hits=METRICS.get("finchat_prefix_hits_total") - hits,
               pages_in_use=sched.allocator.used_count)
    return out


def sp_phase(torch, dev, card: str, results: list) -> dict:
    """Sequence-parallel serving: a long prompt's prefill split over the
    ``seq`` ranks by ring or Ulysses attention, on the one card.

    (a) ``llama3-8b`` at full width over ``PLANE_DEPTH`` layers, random
    weights from seed 0, greedy, with no mesh: the port's chunked prefill of
    the 7,936-token prompt, its peak and device time by class. The whole
    tree stays on rank 0 beside a one-device engine: every served stream of
    (b) is teacher-forced there (``_sp_teacher``: each token the one-device
    argmax wherever its top-2 margin exceeds ``STREAM_MARGIN``, the tokens
    inside gate (b)'s 1e-3 counted).
    (b) Four gloo ranks on the card (ranks 1-3 spawned at the phase's start),
    ``seq=2 x model=2``, the default ``ring_prefill_min_tokens`` and
    ``ring_prefill_chunk`` (4,096), depth 1, served through the scheduler on
    rank 0: the long prompt monolithic; segmented (two segments) with the
    short stream decoding (``mixed_step`` off: it gains a token between the
    segments); the head registered and the prompt's one segment starting
    past it (``finchat_prefix_hits_total`` +1); Ulysses segmented; the long
    prompt admitted while the short stream decodes with ``mixed_step`` on (it
    rides the packed rounds: no seq-sharded entry); int8 weights over an
    int8 KV pool, segmented (the 3,840-token head with a 4,032-token tail in
    the prefix case, the 7,936-token prompt elsewhere, ``SP_NEW`` tokens a
    stream). Every stream teacher-forced on one device; the entries each
    case took; every rank's launches equal; the KV-row writer
    launched once a layer a step; the older bodies never.
    (c) Monolithic, on rank 0: one more ring prefill of the long prompt
    profiled, its device time by class against (a)'s; each rank's peak
    against one device's; K7 at Ulysses' head group on a rank (8 query and
    2 KV heads, S=4,096) against its plain version (a row of the
    ``kernels`` line).
    No number of the phase is an SP speed: a gloo collective stages through
    the host."""
    import multiprocessing as mp
    import queue as queue_mod

    import torch.distributed as dist

    from finchat_tpu_torch.engine import engine as engine_mod
    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
        initialize_distributed,
        make_abstract_mesh,
    )
    from finchat_tpu_torch.parallel.ranks import Leader, RankChannel, rendezvous
    from finchat_tpu_torch.parallel.sharding import llama_param_shardings, shard_params

    t0 = time.perf_counter()
    config = _sp_config(torch)
    prompts = _sp_prompts()
    init = rendezvous()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    followers = [ctx.Process(target=_sp_follower, args=(r, init, str(dev), queue), daemon=True,
                             name=f"sp-rank-{r}") for r in range(1, SP_RANKS)]
    for p in followers:
        p.start()
    out: dict = {"card": card}
    me = make_abstract_mesh((1, 1, 2, 1, 2), rank=0)
    try:
        # (a) one device: the yardstick of (c); the tree stays for teacher forcing
        _free(torch)
        full = _tp_params(torch, config, "bf16", dev)
        one = _sp_one_device(torch, config, full, "bf16", prompts["long"])
        log(f"  sp (a) one device, {SP_LONG}-token prompt: chunked prefill {one['prefill_s']:.3f} s, "
            f"peak {one['peak_gb']:.2f} GB; device ms by class {one['device_ms_by_class']} ({card})")
        out["a"] = one
        out["references_s"] = time.perf_counter() - t0
        log(f"  sp (a) took {out['references_s']:.1f} s (the tree, the prefill twice, the "
            "followers starting meanwhile)")

        # (b) four gloo ranks
        initialize_distributed(SP_RANKS, 0, backend="gloo", init_method=init,
                               timeout_s=SP_TIMEOUT_S, device=dev)
        mesh = build_mesh(MeshSpec(seq=2, model=2), [dev] * SP_RANKS, "gloo",
                          timeout_s=SP_TIMEOUT_S)
        channel = RankChannel(mesh, SP_TIMEOUT_S)
        cases: dict = {}
        summed: dict = {r: {} for r in range(SP_RANKS)}
        steps = ("prefill_step", "decode_step", "ragged_mixed_step", "_sp_prefill")
        shard = teacher = None
        taught: dict = {}
        for name, plane, extra in SP_CASES:
            t_case = time.perf_counter()
            spec = PLANES[plane]
            if teacher is None or teacher.quant_label != plane:
                shard = teacher = None
                if plane != "bf16":
                    full = None
                    _free(torch)
                    full = _tp_params(torch, config, plane, dev)
                # rank 0's shard, and a one-device engine on the whole tree
                shard = shard_params(full, llama_param_shardings(me), me, dev)
                teacher = InferenceEngine(config, full, _sp_engine_cfg(plane, {}), device=dev,
                                          quant=spec["quant"], quant_group=spec["group"])
            engine = InferenceEngine(config, shard, _sp_engine_cfg(plane, extra),
                                     device=dev, quant=spec["quant"], quant_group=spec["group"],
                                     mesh=mesh)
            if engine.sp_mode != extra.get("sp_mode", "ring"):
                fail(f"sp (b) {name}: the engine runs {engine.sp_mode}")
            counted = {s: 0 for s in steps}
            real = {s: getattr(engine_mod, s) for s in steps}

            def counting(s):
                def call(*a, **k):
                    counted[s] += 1
                    return real[s](*a, **k)
                return call

            leader = Leader(engine, channel)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            try:
                for s in steps:
                    setattr(engine_mod, s, counting(s))
                try:
                    r = asyncio.run(_sp_serve(torch, engine, name, prompts))
                    if name == "monolithic":  # (c): one more ring prefill, profiled
                        r["profile"] = _sp_profile(torch, engine, prompts["long"])
                finally:
                    for s in steps:
                        setattr(engine_mod, s, real[s])
                torch.cuda.synchronize()
                r["launches"] = {k: n for k, n in LAUNCHES.items() if n}
                # rank 0's own: less the whole tree and the one-device engine's
                # pool that the parent holds beside it for teacher forcing
                held = _tree_bytes(full) + pool_bytes(teacher)
                r["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
                r["steps"] = dict(counted)
            finally:
                leader.stop()
            got = {0: dict(launches=r["launches"], peak_gb=r["peak_gb"], calls=None)}
            for _ in range(SP_RANKS - 1):
                try:
                    rank, case, res = queue.get(timeout=SP_TIMEOUT_S)
                except queue_mod.Empty:
                    fail(f"sp (b) {name}: a rank sent no result in time")
                if case == "error":
                    fail(f"sp (b): rank {rank} failed:\n{res}")
                got[rank] = dict(res, launches={k: n for k, n in res["launches"].items() if n})
            r["followers_s"] = time.perf_counter() - t_case - r["wall_s"]
            t_teach = time.perf_counter()
            long_ids = prompts["prefixed" if name == "prefix" else "long"]
            r["teacher_forced"] = {}
            for key, ids in (("long", long_ids), ("short", prompts["short"])):
                if key not in r:
                    continue
                memo = (plane, tuple(ids), tuple(r[key]))  # a stream served alike is held once
                if memo not in taught:
                    taught[memo] = _sp_teacher(torch, teacher, f"{name} {key}", ids, r[key])
                r["teacher_forced"][key] = taught[memo]
            r["teacher_s"] = time.perf_counter() - t_teach
            _sp_check(name, plane, r, got)
            for rank, g in got.items():
                for k, n in g["launches"].items():
                    summed[rank][k] = summed[rank].get(k, 0) + n
            cases[name] = dict(r, ranks=got)
            del engine, leader
            _free(torch)
        shard = teacher = full = None
        dist.destroy_process_group()
        if any(summed[k] != summed[0] for k in summed):
            fail(f"sp (b): the ranks' launches differ: {summed}")
        out["b"] = cases
        out["launches"] = {k: summed[0].get(k, 0) for k in LAUNCHES}
        prof = cases["monolithic"]["profile"]
        peaks = {rank: max(c["ranks"][rank]["peak_gb"] for c in cases.values())
                 for rank in range(SP_RANKS)}
        log(f"  sp (c) monolithic ring prefill of {SP_LONG} tokens on rank 0: wall "
            f"{prof['wall_s']:.3f} s (host-paced over gloo: not an SP rate); device ms by class "
            f"{prof['device_ms_by_class']} against one device's chunked prefill "
            f"{one['device_ms_by_class']}; peak GB by rank {peaks} against one device's "
            f"{one['peak_gb']:.2f} ({card})")
        out["c"] = dict(profile=prof, peak_gb_by_rank=peaks, one_device_peak_gb=one["peak_gb"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in followers:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
                fail(f"sp: {p.name} did not stop")
    for p in followers:
        if p.exitcode != 0:
            fail(f"sp: {p.name} exited with {p.exitcode}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2828)
    with _RankHeads(8, 2):
        check_flash(torch, "flash_fwd_causal_s4096_h8_kv2", gen, dev, 1, 4096, 4096, [0], [4096],
                    results, launch_plane="sp")
    out["seconds"] = time.perf_counter() - t0
    return out


def _sp_profile(torch, engine, prompt: list[int]) -> dict:
    """One ring prefill of ``prompt`` into fresh pages of slot 0 (every rank
    mirrors it), profiled on rank 0: its wall and device time by class."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    pages = list(range(1, 1 + -(-len(prompt) // engine.page_size)))
    engine.set_page_table_row(0, pages)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.prefill_ring(0, list(prompt))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.reset_slot(0)
    by_class, top = device_ms(torch, prof, _sp_class)
    return dict(wall_s=wall, device_ms_by_class=by_class, device_busy_ms=sum(by_class.values()),
                top_other=top)


def _sp_check(name: str, plane: str, r: dict, got: dict) -> None:
    """(b)'s checks of one case (see ``sp_phase``), the streams'
    teacher-forcing done."""
    spec = PLANES[plane]
    L = PLANE_DEPTH
    kinds = [e for e, _ in r["entries"]]
    want = {"monolithic": ["prefill_ring"],
            "segmented": ["prefill_ring_segment", "prefill_ring", "prefill_ring_segment"],
            "prefix": ["prefill_ring_segment"],
            "ulysses": ["prefill_ring_segment", "prefill_ring", "prefill_ring_segment"],
            "mixed": [],
            "int8": ["prefill_ring_segment", "prefill_ring", "prefill_ring_segment"]}[name]
    if kinds != want:
        fail(f"sp (b) {name}: seq-sharded entries {kinds}, the schedule implies {want}")
    if name == "segmented":
        at = [g for e, g in r["entries"] if e == "prefill_ring_segment"]
        if not at[1] > at[0]:
            fail(f"sp (b) segmented: the short stream gained no token between the segments "
                 f"({at})")
    if name == "prefix" and r["prefix_hits"] != 1:
        fail(f"sp (b) prefix: finchat_prefix_hits_total rose by {r['prefix_hits']}")
    writes = L * sum(r["steps"].values())
    writer = "kv_append_q8_sm90" if spec["kv_quant"] else "kv_append_sm90"
    launched = r["launches"]
    k7 = launched.get("flash_attention_sm90", 0)
    # Ulysses' plain step (the first segment) runs K7 once a layer; its
    # segment step folds in fp32
    want_k7 = L * kinds.count("prefill_ring") if name == "ulysses" else 0
    bad = [k for k in spec["never"] if launched.get(k)]
    if launched.get(writer, 0) != writes or bad or k7 != want_k7 or r["pages_in_use"]:
        fail(f"sp (b) {name}: {writer} launched {launched.get(writer, 0)} times against {writes} "
             f"({L} layers x {r['steps']}); older bodies launched {bad}; K7 {k7} against "
             f"{want_k7}; pages still held {r['pages_in_use']}")
    if any(g["launches"] != launched for g in got.values()):
        fail(f"sp (b) {name}: the ranks' launches differ: "
             f"{ {k: g['launches'] for k, g in got.items()} }")
    modes = {k: g.get("sp_mode") for k, g in got.items() if k}
    if set(modes.values()) != {"ulysses" if name == "ulysses" else "ring"}:
        fail(f"sp (b) {name}: the followers run {modes}")
    log(f"  sp (b) {name} ({plane}): streams teacher-forced on one device "
        f"{r['teacher_forced']} ({r['teacher_s']:.2f} s) in {r['wall_s']:.2f} s (the engines "
        f"and the followers' results {r['followers_s']:.2f} s more), TTFT {r['ttft_s']:.3f} s (host-paced over gloo: not an SP "
        f"rate); entries {r['entries']}; steps {r['steps']}; followers' modes {modes}; launches "
        f"{launched} on every rank; peak GB by rank "
        f"{ {k: round(g['peak_gb'], 2) for k, g in got.items()} }")


# --------------------------------------------------------------------------


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed", 2)
    if not torch.cuda.is_available():
        fail("no CUDA device is visible (torch.cuda.is_available() is false)", 2)
    if not (REPO / "finchat_tpu_torch" / "csrc").is_dir():
        fail(f"the port package finchat_tpu_torch is not beside {Path(__file__).name}", 3)
    sys.path.insert(0, str(REPO))
    from finchat_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else "unknown"
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: device {kind} ({card}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_s = kernels.build_all()
    log(f"  kernels built in {build_s:.1f} s from {kernels.CSRC}")
    log_resource_usage(kernels.library_path("quant_matmul_sm90.cu"), "quant_matmul_sm90_kernel")
    log_resource_usage(kernels.library_path("quant_matmul_decode_sm90.cu"), "quant_matmul_decode")
    log_resource_usage(kernels.library_path("attention_q8_sm90.cu"), "attention_q8_sm90_kernel")
    # the bf16 prefill body's paged, ragged and contiguous entries, the
    # decode body's instantiations (paged bf16 and int8, ragged bf16) and
    # their merges, K7's Hopper backward (pre-pass, dK/dV and dQ bodies),
    # the KV-row writer's two kernels
    spills = [src for src, kernel in (("attention_bf16_sm90.cu", "attention_bf16_sm90_kernel"),
                                      ("attention_decode_sm90.cu", "attention_decode_sm90"),
                                      ("flash_attention_bwd_sm90.cu", "flash_bwd_"),
                                      ("kv_write_sm90.cu", "kv_write_"))
              if log_resource_usage(kernels.library_path(src), kernel)]
    if spills:
        fail(f"the Hopper kernels of {spills} spill to local memory")

    log("phase 2: kernels against their plain versions (llama3-8b shapes)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results: list[dict] = []
    dec_lens = [int(x) for x in torch.randint(1, 4097, (64,), generator=gen, device=dev)]
    serve_lens = [SERVE_CONTEXT] * 8
    check_paged(torch, "paged_decode", gen, dev, 1, [n - 1 for n in dec_lens], dec_lens, results)
    check_paged(torch, "paged_decode_b8", gen, dev, 1, [n - 1 for n in serve_lens], serve_lens,
                results)
    # the spec verify step's attention: C = 1 + drafts query tokens a slot
    # over the slot batch (its own generator: the cases after it keep their
    # draws); its launches are the decode_planes spec run's
    verify_gen = torch.Generator(device=dev)
    verify_gen.manual_seed(2020)
    C = 1 + VERIFY_DRAFTS
    check_paged(torch, f"paged_verify_c{C}", verify_gen, dev, C, [n - C for n in dec_lens],
                dec_lens, results, launch_plane="spec")
    check_paged(torch, f"paged_verify_c{C}_b8", verify_gen, dev, C,
                [n - C for n in serve_lens], serve_lens, results, launch_plane="spec")
    check_paged(torch, "paged_prefill_q0", gen, dev, 512, [0] * 4, [512] * 4, results)
    check_paged(torch, "paged_prefill_q1024", gen, dev, 512, [1024] * 4, [1536] * 4, results)
    check_paged(torch, "paged_prefill_q2048", gen, dev, 512, [2048] * 4, [2560] * 4, results)
    check_paged(torch, "paged_prefill_b1_q0", gen, dev, 512, [0], [512], results)
    check_paged(torch, "paged_prefill_b1_q2048", gen, dev, 512, [2048], [2560], results)
    check_append(torch, gen, dev, results)
    check_kv_write(torch, dev, results, q8=False)
    dec = [int(x) for x in torch.randint(1, 4096, (60,), generator=gen, device=dev)]
    check_ragged(torch, gen, dev, results, "ragged",
                 [(512, 0), (512, 1024)] + [(1, n - 1) for n in dec], 2048)
    # its own generator: the draws of the cases after it stay as they were
    serve_gen = torch.Generator(device=dev)
    serve_gen.manual_seed(4321)
    check_ragged(torch, serve_gen, dev, results, "ragged_serve", SERVE_ROUND, 2048)
    log("  int8 KV cache:")
    check_paged(torch, "paged_q8_decode", gen, dev, 1, [n - 1 for n in dec_lens], dec_lens,
                results, q8=True)
    check_paged(torch, "paged_q8_decode_b8", gen, dev, 1, [n - 1 for n in serve_lens],
                serve_lens, results, q8=True)
    check_paged(torch, "paged_q8_prefill_q0", gen, dev, 512, [0] * 4, [512] * 4, results,
                q8=True)
    check_paged(torch, "paged_q8_prefill_q1024", gen, dev, 512, [1024] * 4, [1536] * 4,
                results, q8=True)
    check_append_q8(torch, gen, dev, results)
    check_kv_write(torch, dev, results, q8=True)
    dec = [int(x) for x in torch.randint(1, 4096, (60,), generator=gen, device=dev)]
    check_ragged(torch, gen, dev, results, "ragged_q8",
                 [(512, 0), (512, 1024)] + [(1, n - 1) for n in dec], 2048, q8=True)
    log("  fused dequant matmul (the decode body at M <= 64, the Hopper kernel at prefill; v2 "
        "beside each on the same inputs):")
    for label, (K, N) in QMM_DECODE_WEIGHTS.items():
        check_qmm(torch, f"int8_m64_{label}_{K}x{N}", gen, dev, 64, K, N, "int8", 0, False,
                  results)
    check_qmm(torch, "int8_m64_head_fp32", gen, dev, 64, 4096, 128256, "int8", 0, True, results)
    check_qmm(torch, "int8_m4_head_fp32", gen, dev, 4, 4096, 128256, "int8", 0, True, results)
    # mixtral-8x7b's head (vocab 32,000): its own generator (the cases after
    # it keep their draws); its launches are moe_phase's
    moe_gen = torch.Generator(device=dev)
    moe_gen.manual_seed(2525)
    for M in (64, 4):
        check_qmm(torch, f"int8_m{M}_head32000_fp32", moe_gen, dev, M, 4096, 32000, "int8", 0,
                  True, results, launch_plane="moe")
    check_qmm(torch, "int4_g0_m64_4096x14336", gen, dev, 64, 4096, 14336, "int4", 0, False,
              results)
    check_qmm(torch, "int4_g128_m64_4096x14336", gen, dev, 64, 4096, 14336, "int4", 128, False,
              results)
    for M in QMM_PREFILL_ROWS:
        for K, N in QMM_PREFILL_WEIGHTS:
            check_qmm(torch, f"int8_m{M}_{K}x{N}", gen, dev, M, K, N, "int8", 0, False, results)
        check_qmm(torch, f"int4_g128_m{M}_4096x14336", gen, dev, M, 4096, 14336, "int4", 128,
                  False, results)
    log("  fused dequant matmul at bge-base-en's shapes (the int8 encoder: M=2048, an ingest "
        "dispatch of 32 texts in a 64-token bucket; M=32, a lone query):")
    for M in BGE_QMM_ROWS:
        for label, (K, N) in BGE_QMM_WEIGHTS.items():
            check_qmm(torch, f"bge_int8_m{M}_{label}_{K}x{N}", gen, dev, M, K, N, "int8", 0,
                      False, results,
                      # an ingest dispatch's rows, or a lone query's
                      launch_plane="retrieval_ingest" if M > 64 else "retrieval_query")
    log("  contiguous flash attention (training shapes; the Hopper forward and backward, the "
        "older forward and backward by name beside them):")
    check_flash(torch, "flash_fwd_causal_s2048", gen, dev, 1, 2048, 2048, [0], [2048], results)
    check_flash(torch, "flash_fwd_q1024_kv1536", gen, dev, 4, 512, 1536, [1024] * 4, [1536] * 4,
                results)
    check_flash(torch, "flash_bwd_causal_s2048", gen, dev, 1, 2048, 2048, [0], [2048], results,
                backward=True)
    check_flash(torch, "flash_bwd_q1024_kv1536", gen, dev, 4, 512, 1536, [1024] * 4, [1536] * 4,
                results, backward=True)

    log("phase 3, retrieval: bge-base-en (bf16 and int8, random weights), the on-device index "
        f"of {RETRIEVAL_ROWS} rows, the microbatcher and TransactionRetriever")
    retrieval, retrieval_parts = asyncio.run(retrieval_phase(torch, dev, card))
    log("retrieval: " + json.dumps(retrieval))

    serves = {}
    for phase, plane, n_req, max_new, profile, drills, agent in (
            (3, "bf16", 8, 64, True, ("breaker", "preemption"),
             ("constrained", "partial", "turns", "overlap")),
            (4, "int8+kv8", 8, 64, True, ("breaker",), ("constrained", "turns")),
            (5, "int4g128+kv8", 2, 16, False, (), ())):
        log(f"phase {phase}: serve llama3-8b ({plane}, random weights) through LLMService")
        stats = asyncio.run(serve(torch, dev, plane, n_req, max_new, profile,
                                  later_turns=profile, drills=drills, agent=agent,
                                  retrieval=retrieval_parts if plane == "bf16" else None))
        log(f"  TTFT p50 {stats['ttft_p50_s']:.3f} s; decode "
            f"{stats['decode_tokens_per_s']:.1f} tokens/s aggregate, "
            f"{stats['decode_tokens_per_s_per_stream']:.1f} per stream; offloads "
            f"{stats['turn1']['offload']['total_s']:.3f} s ({card})")
        for turn in ("turn2", "turn3"):
            if turn in stats:
                t = stats[turn]
                log(f"  {turn}: TTFT p50 {t['ttft_p50_s']:.3f} s; restores "
                    f"{t['restore']['total_s']:.3f} s, offloads {t['offload']['total_s']:.3f} s "
                    f"({card})")
        tr = stats["tracing"]["host_us_per_dispatch"]
        log(f"  tracing on: {tr['8'][0]:.2f}-{tr['8'][1]:.2f} µs of host a decode dispatch at 8 "
            f"rows, {tr['64'][0]:.2f}-{tr['64'][1]:.2f} at 64 (the ring empty to 20,000 events; "
            f"{card})")
        if stats["agent"]:
            c = stats["agent"]["step_cost"]
            log(f"  constrained: decode step {c['decode_step_ms']:.3f} ms, with one constrained "
                f"row {c['decode_step_one_constrained_row_ms']:.3f} ms; fetch of one row "
                f"{c['fetch_one_row_ms']:.3f} ms; host pick {c['host_pick_ms']:.3f} ms ({card})")
            for i, row in enumerate(stats["agent"].get("partial", {}).get("holds", [])):
                log(f"  partial hold {i}: TTFT from the graft {row['ttft_from_graft_s']:.3f} s, a "
                    f"plain submit's {row['plain_ttft_s']:.3f} s ({card})")
            turns = stats["agent"]["turns"]
            for row in turns["engine_turns"]:
                lead = ("" if row["hold_lead_s"] is None else
                        f", the hold {row['hold_lead_s']:.3f} s before its end")
                log(f"  agent turn {row['conv']}: decision {row['decision_tokens']} tokens in "
                    f"{row['decision_s']:.3f} s{lead}; response TTFT from the turn's start "
                    f"{row['ttft_from_turn_start_s']:.3f} s ({card})")
            for name, run in turns.get("overlap", {}).get("runs", {}).items():
                log(f"  agent overlap {name}: response TTFT from the turn's start "
                    + ", ".join(f"{r['ttft_s']:.3f}" for r in run["turns"])
                    + f" s; finchat_tool_overlap_saved_seconds {run['overlap_saved']['total_s']:.3f}"
                    f" s over {run['overlap_saved']['n']} ({card})")
        log("serve: " + json.dumps(stats))
        serves[plane] = stats
        if plane == "bf16":
            log("phase 3, app_turns: llama3-8b (bf16, random weights) through the serving app: "
                "build_app with its own retriever, Kafka, HTTP, the journal")
            del stats, retrieval_parts
            app = asyncio.run(app_turns(torch, dev, card))
            log("app: " + json.dumps(app))
            log("phase 3, cli: python -m finchat_tpu_torch (llama3-8b, bf16) in a subprocess")
            log("cli: " + json.dumps(cli_phase(torch, card)))
            log("phase 3, checkpoint: llama3-8b and bge-base-en written as HF safetensors "
                "checkpoints, loaded (bf16; int8 at load) and served through build_app "
                "(int8+kv8)")
            ckpt = asyncio.run(checkpoint_phase(torch, dev, card))
            log("checkpoint: " + json.dumps(ckpt))

    log(f"phase 5b, decode_planes: llama3-8b (bf16 and int8+kv8, random weights, {PLANE_DEPTH} "
        "layers): the fused "
        "decode loop (a CUDA graph a block), spec decode, the free-running loop")
    planes = asyncio.run(decode_planes(torch, dev, card))
    for name, r in planes.items():
        if name == "seconds":
            continue
        log(f"  {name}: decode {r['decode_tokens_per_s']:.1f} tokens/s aggregate, "
            f"{r['decode_tokens_per_s_per_stream']:.1f} per stream, TTFT p50 "
            f"{r['ttft_p50_s']:.3f} s, peak {r['peak_gb']:.2f} GB ({PLANE_DEPTH} of the 32 "
            f"layers; {card})")
    log(f"decode_planes ({planes['seconds']:.1f} s): " + json.dumps(planes))

    log(f"phase 5c, bounded_kv: llama3-8b (bf16 and int8+kv8, random weights, {PLANE_DEPTH} "
        "layers) with a sink of 1 page and a window of 16: every row evicts through the Hopper "
        "bodies")
    bkv = asyncio.run(bounded_kv(torch, dev, card))
    for name, r in bkv.items():
        if name == "seconds":
            continue
        log(f"  {name}: TTFT p50 {r['ttft_p50_s']:.3f} s; decode {r['decode_tokens_per_s']:.1f} "
            f"tokens/s aggregate, {r['decode_tokens_per_s_per_stream']:.1f} per stream; pages "
            f"held at peak {r['peak_pages_held']}, evicted {r['pages_evicted']:.0f} ({card})")
        for step, p in r.get("profile", {}).items():
            log(f"  {name} {step}: device busy {p['device_busy_ms']:.3f} ms of "
                f"{p['profiled_window_ms']:.3f} (idle share {p['idle_share']:.3f}); "
                f"{p['event_ms']:.3f} ms a step ({card})")
    log(f"bounded_kv ({bkv['seconds']:.1f} s): " + json.dumps(bkv))

    log("phase 5d, fleet: three llama3-8b replicas (bf16, random weights) over one weight "
        "tree through build_app: prefill,decode,decode; the handoff, a drained trip, the "
        "give-up and respawn")
    fleet = asyncio.run(fleet_phase(torch, dev, card))
    log("fleet: " + json.dumps(fleet))

    log("phase 5e, fabric: two llama3-8b replicas (bf16, random weights) over one weight tree "
        "and one warm-state fabric: the heads prefilled once a fleet, a warm resume on a "
        "replica that never saw the conversation, the migration by the holder index, the "
        "respawn's heads from the fabric")
    fabric = asyncio.run(fabric_phase(torch, dev, card))
    log("fabric: " + json.dumps(fabric))

    log("phase 5f, pod: two llama3-8b hosts (bf16, random weights, a tree each) in one "
        "process: liaisons over loopback TCP, session pulls, a host's death and its adoption")
    pod = asyncio.run(pod_phase(torch, dev, card))
    log("pod: " + json.dumps(pod))

    log("phase 5g, moe: mixtral-8x7b (int8 weights over an int8 KV pool, random weights, 32 "
        "layers at full width) through LLMService; the experts inline-dequantized")
    moe = asyncio.run(moe_phase(torch, dev, card))
    dstep = moe["steps"]["decode_step"]
    log(f"  moe: init {moe['init_s']:.1f} s, peak {moe['peak_gib']:.2f} GiB (the int8 tree "
        f"{moe['tree_gib']:.2f} GiB); TTFT p50 {moe['ttft_p50_s']:.3f} s; decode "
        f"{moe['decode_tokens_per_s']:.2f} tokens/s aggregate, "
        f"{moe['decode_tokens_per_s_per_stream']:.2f} per stream; a decode step "
        f"{dstep['event_ms']:.1f} ms, device "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(dstep["device_ms_by_class"].items(),
                                                       key=lambda x: -x[1]))
        + f" ms ({card})")
    log("moe: " + json.dumps(moe))

    log(f"phase 5h, tp: llama3-8b ({PLANE_DEPTH} layers, random weights) over a mesh: one "
        "NCCL rank against no mesh (depth 1, loop 4), two gloo ranks on the card (bf16, "
        "int8+kv8), a session record across, the per-rank shapes")
    tp = asyncio.run(tp_phase(torch, dev, card, results))
    log(f"tp ({tp['seconds']:.1f} s): " + json.dumps(tp))

    log("phase 6: train llama3-8b (random weights) through K7, forward and backward")
    check = train_check(torch, dev)
    train = train_full(torch, dev, card)
    train["check"] = check
    log("train: " + json.dumps(train))

    log(f"phase 6b, train_mesh: llama3-8b ({TRAIN_MESH_DEPTH} layers) and mixtral-8x7b (2 "
        "layers), random weights, trained over meshes: one NCCL rank against no mesh; four "
        "gloo ranks on the card: data=2 x model=2, pipe=2 x model=2, expert=2 x model=2; K7 at "
        "a rank's heads")
    train_mesh = train_mesh_phase(torch, dev, card, results)
    log(f"train_mesh ({train_mesh['seconds']:.1f} s): " + json.dumps(train_mesh))

    log(f"phase 6c, sp: llama3-8b ({PLANE_DEPTH} layers, random weights) served with a long "
        "prompt's prefill split over seq: four gloo ranks on the card, seq=2 x model=2; ring "
        "monolithic and segmented, a shared head, Ulysses, packed rounds, int8+kv8")
    sp = sp_phase(torch, dev, card, results)
    log(f"sp ({sp['seconds']:.1f} s): " + json.dumps(sp))

    src = "finchat_tpu_torch/csrc/"
    paged = "finchat_tpu/ops/paged_attention.py:305"
    q8_paged = "finchat_tpu/ops/paged_attention.py:221"
    ragged = "finchat_tpu/ops/ragged_paged_attention.py:383"
    q8_ragged = "finchat_tpu/ops/ragged_paged_attention.py:478"
    qmm = "finchat_tpu/ops/quant_matmul.py:144"
    flash = "finchat_tpu/ops/flash_attention.py:160"  # the backward: the gradient of it
    # kernel -> (source, TPU kernel it replaces, serving plane or training
    # run whose main path gives its launches)
    kernel_rows = {
        "paged_attention": ("paged_attention.cu", paged, "bf16"),
        "paged_attention_sm90": ("attention_bf16_sm90.cu", paged, "bf16"),
        "kv_append": ("kv_append.cu", "finchat_tpu/ops/kv_append.py:241", "bf16"),
        "kv_append_sm90": ("kv_write_sm90.cu", "finchat_tpu/ops/kv_append.py:241", "bf16"),
        "ragged_paged_attention": ("ragged_paged_attention.cu", ragged, "bf16"),
        "ragged_paged_attention_sm90": ("attention_bf16_sm90.cu", ragged, "bf16"),
        "ragged_paged_attention_decode_sm90": ("attention_decode_sm90.cu", ragged, "bf16"),
        "paged_attention_q8": ("paged_attention.cu", q8_paged, "int8+kv8"),
        "paged_attention_q8_sm90": ("attention_q8_sm90.cu", q8_paged, "int8+kv8"),
        "paged_attention_decode_sm90": ("attention_decode_sm90.cu", paged, "bf16"),
        "paged_attention_q8_decode_sm90": ("attention_decode_sm90.cu", q8_paged, "int8+kv8"),
        "kv_append_q8": ("kv_append.cu", "finchat_tpu/ops/kv_append.py:175", "int8+kv8"),
        "kv_append_q8_sm90": ("kv_write_sm90.cu", "finchat_tpu/ops/kv_append.py:175",
                              "int8+kv8"),
        "ragged_paged_attention_q8": ("ragged_paged_attention.cu", q8_ragged, "int8+kv8"),
        "ragged_paged_attention_q8_sm90": ("attention_q8_sm90.cu", q8_ragged, "int8+kv8"),
        "quant_matmul_int8": ("quant_matmul.cu", qmm, "int8+kv8"),
        "quant_matmul_int8_sm90": ("quant_matmul_sm90.cu", qmm, "int8+kv8"),
        "quant_matmul_int4": ("quant_matmul.cu", qmm, "int4g128+kv8"),
        "quant_matmul_int4_sm90": ("quant_matmul_sm90.cu", qmm, "int4g128+kv8"),
        "quant_matmul_int8_decode_sm90": ("quant_matmul_decode_sm90.cu", qmm, "int8+kv8"),
        "quant_matmul_int4_decode_sm90": ("quant_matmul_decode_sm90.cu", qmm, "int4g128+kv8"),
        "flash_attention": ("flash_attention.cu", flash, "train"),
        "flash_attention_sm90": ("attention_bf16_sm90.cu", flash, "train"),
        "flash_attention_bwd": ("flash_attention.cu", flash, "train"),
        "flash_attention_bwd_sm90": ("flash_attention_bwd_sm90.cu", flash, "train"),
    }
    launched = {plane: stats["launches"] for plane, stats in serves.items()}
    launched["train"] = train["launches"]
    launched["retrieval_ingest"] = retrieval["launches"]["ingest"]
    launched["retrieval_query"] = retrieval["launches"]["query"]
    launched["spec"] = planes["bf16 spec3"]["launches"]
    launched["checkpoint"] = ckpt["launches"]
    launched["fleet"] = fleet["launches"]
    launched["fabric"] = fabric["launches"]
    launched["pod"] = pod["launches"]
    launched["moe"] = moe["launches"]
    launched["tp"] = tp["launches"]
    launched["train_mesh"] = train_mesh["launches"]
    launched["sp"] = sp["launches"]
    # each rank's launches in the tp phase: the one-rank NCCL mesh's (both
    # depths), and rank 0's and rank 1's over the two gloo planes
    tp_ranks = {"tp_one_rank_launches": {}, "tp_rank0_launches": {}, "tp_rank1_launches": {}}
    for run in tp["one_rank_nccl"].values():
        for k, n in run["launches"].items():
            tp_ranks["tp_one_rank_launches"][k] = tp_ranks["tp_one_rank_launches"].get(k, 0) + n
    for run in tp["two_ranks_gloo"].values():
        for col, key in (("tp_rank0_launches", "launches"),
                         ("tp_rank1_launches", "follower_launches")):
            for k, n in run[key].items():
                tp_ranks[col][k] = tp_ranks[col].get(k, 0) + n
    table = []
    for r in results:
        kname = r["kernel"]
        source, replaces, plane = kernel_rows[kname]
        plane = r.get("launch_plane", plane)
        row = {
            "name": kname if r["case"] == kname else f"{kname}[{r['case']}]",
            "route": "cuda", "source": src + source, "replaces": replaces,
            "launches": launched[plane][kname], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        for key in ("wrapper_ms", "pair_ms"):
            if key in r:
                row[key] = r[key]
        # the same kernel's launches in the checkpoint phase's serve
        row["checkpoint_launches"] = launched["checkpoint"].get(kname, 0)
        # and in the fleet phase's window (every replica's)
        row["fleet_launches"] = launched["fleet"].get(kname, 0)
        # and in the fabric and the pod phases' windows
        row["fabric_launches"] = launched["fabric"].get(kname, 0)
        row["pod_launches"] = launched["pod"].get(kname, 0)
        # and in the Mixtral serve's window
        row["moe_launches"] = launched["moe"].get(kname, 0)
        # and on each rank of the tp phase
        for col, counts in tp_ranks.items():
            row[col] = counts.get(kname, 0)
        # and on rank 0 of the train_mesh phase's four gloo ranks (equal on
        # every rank)
        row["train_mesh_launches"] = launched["train_mesh"].get(kname, 0)
        # and on rank 0 of the sp phase's four gloo ranks (equal on every rank)
        row["sp_launches"] = launched["sp"].get(kname, 0)
        table.append(row)
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
