"""Model and engine configuration (own copy; no Kafka/Mongo/fleet sections).

Field names and defaults are those of the JAX package's ``ModelConfig`` and
``EngineConfig`` so a config written for one package reads the same in the
other. ``EngineConfig()`` as it stands is served. The serving planes this
port does not carry yet (spec decode, decode loop, free-run, bounded KV)
keep their fields; the scheduler refuses a config that turns one of them on
(engine/scheduler.py ``check_supported``). The prefix and session KV caches
are served at their defaults: the scheduler reads ``session_cache``,
``session_cache_bytes``, ``session_cache_disk_path`` and
``session_cache_disk_bytes``, and a caller registers shared heads itself
(``register_prefix``). Recompute preemption and the circuit breaker are on
by default, as in the reference: the scheduler reads ``preemption``,
``breaker_threshold``, ``breaker_max_rebuilds``, ``edf_starvation_seconds``
and ``max_queue_depth``. ``request_deadline_seconds`` and
``warmup_on_start`` are read by the serving app, as in the reference (the
engine's ``warmup`` is there to call). ``kv_quant = "int8"`` (int8 KV
pages) and ``ModelConfig.quant`` (int8/int4 weights) are served.
Grammar-constrained decoding (``SamplingParams.grammar``) and the partial
holds of the retrieval overlap are served: the scheduler reads
``partial_hold_ttl_seconds``. ``retrieval_overlap`` and ``tool_streaming``
are the agent's switches: ``LLMAgent`` (agent/graph.py) takes them as
arguments, as the reference's does, and the serving app is what passes
these fields to it.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ModelConfig:
    """Which decoder to serve and how to load it."""

    preset: str = "tiny"  # see models/llama.py PRESETS
    checkpoint_path: str = ""  # empty = random init
    tokenizer_path: str = ""  # empty = byte tokenizer
    dtype: str = "bfloat16"
    seed: int = 0
    quant: str = ""  # weight-only quantized serving: "" | "int8" | "int4"
    quant_group: int = 0  # int4 rows of K per scale (0 = one scale per column)


@dataclass
class EngineConfig:
    """Inference engine + continuous-batching scheduler settings."""

    max_seqs: int = 64  # concurrent sequences
    page_size: int = 128  # tokens per KV page
    num_pages: int = 512  # total pages in the paged KV cache (page 0 = trash)
    max_seq_len: int = 8192
    prefill_chunk: int = 512  # chunked prefill granularity
    max_new_tokens: int = 1024
    temperature: float = 0.5
    top_p: float = 1.0
    top_k: int = 0
    watchdog_seconds: float = 100.0
    stream_flush_tokens: int = 1
    warmup_on_start: bool = True
    ring_prefill_min_tokens: int = 4096
    spec_tokens: int = 0
    prefix_cache: bool = True
    session_cache: bool = True
    session_cache_bytes: int = 256 << 20
    session_cache_disk_path: str = ""
    session_cache_disk_bytes: int = 4 << 30
    kv_quant: str = ""
    sp_mode: str = "ring"
    decode_loop_depth: int = 1
    retrieval_overlap: bool = True
    partial_hold_ttl_seconds: float = 30.0
    tool_streaming: bool = True
    # one packed ragged dispatch per scheduler iteration whenever prefill
    # work and in-flight decodes coexist (engine ragged_mixed_step)
    mixed_step: bool = True
    freerun_rounds: int = 1
    tp_overlap: bool = False
    tp_overlap_chunks: int = 4
    compilation_cache_dir: str = ""
    breaker_threshold: int = 3
    breaker_max_rebuilds: int = 2
    preemption: bool = True
    request_deadline_seconds: float = 0.0
    edf_starvation_seconds: float = 10.0
    max_queue_depth: int = 0
    ring_prefill_chunk: int = 4096
    kv_sink_pages: int = 0
    kv_window_pages: int = 0
