"""The port's embedding encoder (``embed/encoder.py``) against the JAX
package's, on the same weights (the JAX tree converted bit for bit by
``bert_params_from_numpy``) and the same texts.

- fp32 (2 layers, dim 64, both poolings): the normalized embeddings within
  1e-5 of the JAX package's.
- bf16, and int8 weights through the fused dequant matmul (the JAX side
  runs its Pallas kernel in interpret mode, the port its plain version on
  the CPU): per-row cosine >= 0.999 and top-10 overlap of a corpus ranking
  >= 0.99.
- The weight conversion and ``quantize_bert_params`` bit for bit across
  packages; the tokenizer's encoder framing; padding invariance and
  normalization, as tests/test_embed.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.embed import encoder as jenc  # noqa: E402
from finchat_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer  # noqa: E402
from finchat_tpu_torch.embed import encoder as tenc  # noqa: E402
from finchat_tpu_torch.models.quant import QTensor  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402

CORPUS = [
    f"{i}: {kind} {3 * i + 7}.{(13 * i) % 100:02d} at {place}-{i % 7}"
    for i, (kind, place) in enumerate(
        (kind, place)
        for kind in ("coffee", "grocery", "rent", "salary", "transfer")
        for place in ("acme", "downtown", "north", "airport"))
]
QUERIES = ["coffee purchases", "rent payment", "salary deposit", "airport spending",
           "grocery run downtown"]
# the bf16 and int8 ranking gate: a pick whose reference score sits within
# EPS of the rank-K boundary is a near tie, not a ranking change (the rule
# of tests/test_quant_serving.py's quantized-encoder gate)
K, EPS = 10, 2e-3


def _configs(dtype_name: str, pooling: str):
    jcfg = jenc.BertConfig(dtype=getattr(jnp, dtype_name), pooling=pooling)
    tcfg = tenc.BertConfig(dtype=getattr(torch, dtype_name), pooling=pooling)
    return jcfg, tcfg


def _pair(dtype_name: str, pooling: str = "mean", quant: str = ""):
    """(JAX encoder, port encoder) over the same weights."""
    jcfg, tcfg = _configs(dtype_name, pooling)
    jparams = jenc.init_bert_params(jcfg, jax.random.key(0))
    tparams = tenc.bert_params_from_numpy(jax.device_get(jparams), "cpu")
    jax_enc = jenc.EmbeddingEncoder(jcfg, jparams, JaxTokenizer(), quant=quant)
    port_enc = tenc.EmbeddingEncoder(tcfg, tparams, ByteTokenizer(), quant=quant, device="cpu")
    return jax_enc, port_enc


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _topk_overlap(ref_corpus, ref_queries, got_corpus, got_queries) -> float:
    overlaps = []
    for qi in range(len(ref_queries)):
        s = ref_corpus @ ref_queries[qi]
        picked = np.argsort(-(got_corpus @ got_queries[qi]), kind="stable")[:K]
        kth = np.sort(s)[-K]
        overlaps.append(float(np.mean(s[picked] >= kth - EPS)))
    return float(np.mean(overlaps))


def test_tokenizer_frames_like_the_jax_package():
    for text in ("coffee $4.50", "héllo", ""):
        assert ByteTokenizer().encode_with_specials(text) == \
            JaxTokenizer().encode_with_specials(text)
    wide = ByteTokenizer(vocab_size=128256)  # the 8B's tokenizer (serve/app.py)
    assert wide.encode_with_specials("a") == [257, 97, 258]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_bert_params_from_numpy_bit_for_bit(dtype_name):
    jcfg, _t = _configs(dtype_name, "mean")
    tree = jax.device_get(jenc.init_bert_params(jcfg, jax.random.key(3)))
    port = tenc.bert_params_from_numpy(tree, "cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_j) == 16
    for path, leaf in flat_j:
        node = port
        for key in path:
            node = node[key.key]
        assert node.dtype == getattr(torch, dtype_name) and tuple(node.shape) == leaf.shape
        t_bits, np_bits = ((torch.int16, np.int16) if dtype_name == "bfloat16"
                           else (torch.int32, np.int32))
        np.testing.assert_array_equal(node.view(t_bits).numpy(), np.asarray(leaf).view(np_bits))


def test_quantize_bert_params_equal_across_packages():
    jcfg, _t = _configs("bfloat16", "mean")
    jparams = jenc.init_bert_params(jcfg, jax.random.key(4))
    jq = jax.device_get(jenc.quantize_bert_params(jparams))
    port_q = tenc.quantize_bert_params(tenc.bert_params_from_numpy(jax.device_get(jparams), "cpu"))
    carried = tenc.bert_params_from_numpy(jq, "cpu")  # the JAX QTensors carried across
    for name in tenc.BERT_QUANT_LEAVES:
        mine, theirs = port_q["layers"][name], carried["layers"][name]
        assert isinstance(mine, QTensor) and isinstance(theirs, QTensor)
        assert mine.q.dtype == torch.int8 and mine.scale.dtype == torch.float32
        assert torch.equal(mine.q, theirs.q) and torch.equal(mine.scale, theirs.scale)
    assert tenc.quantize_bert_params(port_q)["layers"]["qkv"] is port_q["layers"]["qkv"]
    for name in ("qkv_bias", "ln1_scale"):
        assert torch.equal(port_q["layers"][name], carried["layers"][name])


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_encoder_parity_fp32(pooling):
    jax_enc, port_enc = _pair("float32", pooling)
    texts = CORPUS[:12] + ["x" * 40, "a"]  # two buckets, a one-byte text
    want, got = jax_enc.embed_batch(texts), port_enc.embed_batch(texts)
    assert got.dtype == np.float32 and got.shape == (len(texts), 64)
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("quant", ["", "int8"])
def test_encoder_parity_bf16_and_int8(monkeypatch, quant):
    """bf16, and int8 with the JAX package's own Pallas kernel in interpret
    mode on its side (``FINCHAT_QUANT_MATMUL=pallas-interpret``, resolved
    once at construction) against the port's plain quantized matmul."""
    if quant:
        monkeypatch.setenv("FINCHAT_QUANT_MATMUL", "pallas-interpret")
    jax_enc, port_enc = _pair("bfloat16", "cls", quant=quant)
    assert jax_enc.qm_backend == ("pallas-interpret" if quant else "ref")
    want_c, got_c = jax_enc.embed_batch(CORPUS), port_enc.embed_batch(CORPUS)
    want_q, got_q = jax_enc.embed_batch(QUERIES), port_enc.embed_batch(QUERIES)
    assert _cosines(got_c, want_c).min() >= 0.999
    assert _cosines(got_q, want_q).min() >= 0.999
    assert _topk_overlap(want_c, want_q, got_c, got_q) >= 0.99


def test_int8_encoder_ranks_like_bf16():
    """The port's own quality gate, as tests/test_quant_serving.py holds the
    JAX package's: int8 rankings overlap the full-precision encoder's."""
    cfg = tenc.EMBED_PRESETS["bge-tiny"]
    gen = torch.Generator().manual_seed(0)
    params = tenc.init_bert_params(cfg, gen, "cpu")
    enc = tenc.EmbeddingEncoder(cfg, params, ByteTokenizer(), device="cpu")
    encq = tenc.EmbeddingEncoder(cfg, params, ByteTokenizer(), quant="int8", device="cpu")
    assert isinstance(encq.params["layers"]["mlp_in"], QTensor)
    overlap = _topk_overlap(enc.embed_batch(CORPUS), enc.embed_batch(QUERIES),
                            encq.embed_batch(CORPUS), encq.embed_batch(QUERIES))
    assert overlap >= 0.99
    with pytest.raises(ValueError, match="int4"):
        tenc.EmbeddingEncoder(cfg, params, ByteTokenizer(), quant="int4", device="cpu")


@pytest.fixture(scope="module")
def encoder():
    cfg = tenc.EMBED_PRESETS["bge-tiny"]
    params = tenc.init_bert_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return tenc.EmbeddingEncoder(cfg, params, ByteTokenizer(), device="cpu")


def test_embeddings_normalized(encoder):
    out = encoder.embed_batch(["hello world", "rent payment"])
    assert out.shape == (2, encoder.dim)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)


def test_padding_invariance(encoder):
    """A text's embedding does not depend on the batch or bucket it rode in."""
    solo = encoder.embed_query("coffee shop purchase")
    batched = encoder.embed_batch(["coffee shop purchase", "x" * 100])[0]
    np.testing.assert_allclose(solo, batched, atol=2e-2)


def test_micro_batches_and_buckets(encoder):
    """``batch_size`` splits the device calls without changing a row, and
    the buckets are the JAX package's."""
    texts = [f"row {i}" for i in range(5)]
    small = tenc.EmbeddingEncoder(encoder.config, encoder.params, ByteTokenizer(),
                                  batch_size=2, device="cpu")
    np.testing.assert_array_equal(small.embed_batch(texts), encoder.embed_batch(texts))
    assert [encoder._bucket(n) for n in (1, 32, 33, 300, 600)] == [32, 32, 64, 512, 512]
    assert tenc._BUCKETS == jenc._BUCKETS
    assert tenc.EMBED_PRESETS["bge-base-en"].dim == jenc.EMBED_PRESETS["bge-base-en"].dim == 768
