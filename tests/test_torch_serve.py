"""End to end on CPU: ``LLMService`` over ``EngineGenerator`` over the port's
scheduler, against the JAX package's service on the same weights.

Three greedy requests on ``tiny`` fp32; the third is submitted once the
first has streamed a token, so its prefill coexists with decode and the
port runs at least one packed ragged round. The scheduler's delivered token
ids are recorded on both sides (the byte tokenizer gives ids >= 256 no
text, so streamed text alone would hide them).

Tolerance and why: the two token streams of a request must be equal up to
their first difference, and at that step the JAX forward's top-2 logit
margin must be within 1e-3 — an fp32 near tie the frameworks' ~1e-4 logit
noise may flip (after a flip the streams legitimately diverge).
"""

import asyncio
import dataclasses
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.generator import EngineGenerator as JaxGenerator  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from finchat_tpu.serve.simple import LLMService as JaxService  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.generator import EngineGenerator  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat  # noqa: E402
from finchat_tpu_torch.serve.simple import LLMService  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

MARGIN = 1e-3
ENGINE = dict(max_seqs=4, page_size=16, num_pages=48, max_seq_len=256, prefill_chunk=32,
              prefix_cache=False, session_cache=False, preemption=False, breaker_threshold=0,
              warmup_on_start=False)
SYSTEM = "You are Penny, a careful financial assistant."
MESSAGES = ["How much should I save each month?", "Is my rent too high?",
            "Explain an emergency fund in a few words, with an example or two."]
MAX_NEW = 20


def _record(sched) -> dict:
    """Record every delivered token id per sequence id."""
    got: dict[str, list[int]] = defaultdict(list)
    deliver = sched._deliver

    def recording(handle, token_id):
        got[handle.seq_id].append(int(token_id))
        deliver(handle, token_id)

    sched._deliver = recording
    return got


async def _serve(service, sched, third_after_first_token: bool):
    await sched.start()

    async def one(msg):
        return "".join([c async for c in service.process_message(msg, context="ctx")])

    tasks = [asyncio.create_task(one(m)) for m in MESSAGES[:2]]
    while third_after_first_token and not sched.decoding:
        await asyncio.sleep(0.001)
    tasks.append(asyncio.create_task(one(MESSAGES[2])))
    texts = await asyncio.gather(*tasks)
    await sched.stop()
    return texts


def test_llm_service_streams_match_jax():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(5))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    tparams = params_from_numpy(jax.device_get(jparams), "cpu")

    # JAX reference service (its reference attention backend on CPU)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE), attn_backend="ref")
    jtok = JaxByteTokenizer()
    jsched = JaxScheduler(jeng, jtok.eos_id)
    jtokens = _record(jsched)
    jsvc = JaxService(JaxGenerator(jsched, jtok), SYSTEM,
                      JaxSampling(temperature=0.0, max_new_tokens=MAX_NEW))
    asyncio.run(_serve(jsvc, jsched, third_after_first_token=False))

    # the port
    teng = InferenceEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu")
    tok = ByteTokenizer()
    tsched = ContinuousBatchingScheduler(teng, tok.eos_id)
    ttokens = _record(tsched)
    tsvc = LLMService(EngineGenerator(tsched, tok), SYSTEM,
                      SamplingParams(temperature=0.0, max_new_tokens=MAX_NEW))
    mixed0 = METRICS.get("finchat_mixed_dispatches_total")
    coexist0 = METRICS.get("finchat_coexist_iterations_total")
    texts = asyncio.run(_serve(tsvc, tsched, third_after_first_token=True))

    assert METRICS.get("finchat_mixed_dispatches_total") > mixed0, "no ragged round ran"
    assert METRICS.get("finchat_coexist_iterations_total") > coexist0
    assert tsched.allocator.used_count == 0
    tsched.allocator.check_invariants()
    assert len(texts) == 3 and len(ttokens) == 3
    for i, msg in enumerate(MESSAGES):
        seq = f"seq-{i}"
        want, got = jtokens[seq], ttokens[seq]
        assert got and want
        n = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if n is None:
            assert got == want
            continue
        prompt = jtok.encode(render_chat(SYSTEM, "ctx", [], msg), add_bos=True)
        ids = jnp.asarray([prompt + want[:n]], jnp.int32)
        logits = np.asarray(jllama.forward_full(
            jparams, ids, jnp.arange(ids.shape[1])[None], config=jcfg, attn_backend="ref"))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= MARGIN, (seq, n, got[n], want[n], top2)
