"""The port's ``HFTokenizer`` (``tokenizers`` only) against the JAX
package's (``transformers.AutoTokenizer``) on the same directories.

Four tokenizers are written here by the ``tokenizers`` package, nothing is
downloaded:

- ``bytelevel``: the byte-level BPE of tests/test_tokenizer.py (specials in
  its trained vocab, plain-string specials in its config, no
  ``clean_up_tokenization_spaces`` key);
- ``sentencepiece``: a Llama-2-style BPE with ``byte_fallback`` and
  ``<0xNN>`` pieces, a ``Metaspace`` pre-tokenizer, ``<s>`` framing, a pad
  token the vocabulary lacks (given as an ``AddedToken`` dict: both
  packages add it), and ``clean_up_tokenization_spaces`` on;
- ``prefix_space``: the first with ``add_prefix_space`` on in its
  pre-tokenizer, which a config that leaves it out turns off;
- ``llama3``: a Llama-3-style byte-level BPE with added special tokens
  beyond the special-tokens map (``<|eot_id|>``, header tokens), the
  config's ``added_tokens_decoder``, ``<|begin_of_text|>`` framing and a
  ``special_tokens_map.json`` naming another eos, which a config with an
  ``added_tokens_decoder`` overrides (the sentencepiece one, a legacy
  config, takes its map's plain ``{"content": ...}`` dict).

For each, the port equals the JAX package: ``vocab_size`` and the four
special ids, ``encode`` with and without bos, ``encode_with_specials``,
``decode`` (a text the clean-up would change among them), the
``IncrementalDecoder`` pieces, ``token_texts`` and ``GrammarVocab`` masks
along a walk of grammar states. Plus ``get_tokenizer``'s dispatch and the
two refusals.
"""

from __future__ import annotations

import builtins
import json

import numpy as np
import pytest

pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from tokenizers import (  # noqa: E402
    AddedToken,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    processors,
    trainers,
)

from finchat_tpu.agent import constrained as jcon  # noqa: E402
from finchat_tpu.models import tokenizer as jtok  # noqa: E402
from finchat_tpu_torch.agent import constrained as tcon  # noqa: E402
from finchat_tpu_torch.models import tokenizer as ttok  # noqa: E402

CORPUS = ["hello world", "what did I spend on groceries?", "retrieve_transactions",
          '{"search_query": "recent"}', "🎉 良い", "No tool call", "I can't do it, ok?",
          'create_financial_plot({"chart_type": "pie"})', "num_transactions time_period_days"]
TEXTS = ["what did I spend on groceries?", "hello 🎉 良い world", "I do n't know , ok ?",
         "No tool call", 'retrieve_transactions({"search_query": "coffee"})', ""]
STREAM = "hello 🎉 良い world"
WALKS = ["No tool call", 'retrieve_transactions({"search_query": "coffee"})']


def _bytelevel(path, add_prefix_space: bool = False):
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=add_prefix_space)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=320, special_tokens=["<s>", "</s>", "<pad>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS, trainer)
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": "<s>", "eos_token": "</s>", "pad_token": "<pad>"}))


def _sentencepiece(path):
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for ch in "▁abcdefghijklmnopqrstuvwxyzINCO,?'\"{}():_":
        vocab.setdefault(ch, len(vocab))
    merges = [("▁", "t"), ("o", "o"), ("▁t", "oo"), ("▁", "c"), ("a", "l"), ("▁c", "al"),
              ("l", "l"), ("▁", "N"), ("▁N", "o"), ("e", "l"), ("el", "l"), ("ell", "o"),
              ("▁", "h"), ("▁h", "ello")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token="<unk>",
                               byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[
        ("<s>", 1)])
    tok.add_special_tokens(["<unk>", "<s>", "</s>"])
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "clean_up_tokenization_spaces": True,
        "bos_token": {"__type": "AddedToken", "content": "<s>", "lstrip": False,
                      "normalized": False, "rstrip": False, "single_word": False},
        "eos_token": "</s>", "unk_token": "<unk>",
        "pad_token": {"__type": "AddedToken", "content": "<pad>", "lstrip": False,
                      "normalized": False, "rstrip": False, "single_word": False}}))
    # a legacy config (no added_tokens_decoder): the map's values win
    (path / "special_tokens_map.json").write_text(json.dumps({
        "eos_token": {"content": "</s>", "lstrip": False, "normalized": False,
                      "rstrip": False, "single_word": False},
        "unk_token": "<unk>", "pad_token": "<pad>"}))


LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                   "<|end_header_id|>", "<|eot_id|>"]


def _llama3(path):
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(tokenizers.Regex(r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?"
                                              r"\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|"
                                              r"\s*[\r\n]+|\s+(?!\S)|\s+"),
                             behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=330, initial_alphabet=pre_tokenizers.ByteLevel
                                  .alphabet())
    tok.train_from_iterator(CORPUS, trainer)
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                            for t in LLAMA3_SPECIALS])
    bot = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.TemplateProcessing(
        single="<|begin_of_text|> $A", special_tokens=[("<|begin_of_text|>", bot)])
    tok.save(str(path / "tokenizer.json"))
    decoder = {str(tok.token_to_id(t)): {"content": t, "lstrip": False, "normalized": False,
                                         "rstrip": False, "single_word": False, "special": True}
               for t in LLAMA3_SPECIALS}
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "added_tokens_decoder": decoder,
        "bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>",
        "clean_up_tokenization_spaces": True}))
    # a map naming another eos: a config with added_tokens_decoder wins
    (path / "special_tokens_map.json").write_text(json.dumps({
        "bos_token": {"content": "<|begin_of_text|>", "lstrip": False, "normalized": False,
                      "rstrip": False, "single_word": False},
        "eos_token": "<|eot_id|>"}))


KINDS = {"bytelevel": _bytelevel, "sentencepiece": _sentencepiece, "llama3": _llama3,
         # a GPT-2-style pre-tokenizer adding a prefix space, which a config
         # without add_prefix_space turns off in both packages
         "prefix_space": lambda path: _bytelevel(path, add_prefix_space=True)}


@pytest.fixture(scope="module", params=list(KINDS))
def pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(f"tok_{request.param}")
    KINDS[request.param](path)
    return request.param, ttok.HFTokenizer(str(path)), jtok.HFTokenizer(str(path))


def test_vocab_size_and_special_ids(pair):
    kind, t, j = pair
    got = (t.vocab_size, t.bos_id, t.eos_id, t.pad_id, t.eot_id)
    assert got == (j.vocab_size, j.bos_id, j.eos_id, j.pad_id, j.eot_id)
    if kind == "sentencepiece":
        # the config's pad token is not in the vocabulary: both add it
        assert t.pad_id == t.vocab_size - 1 != t.eos_id
    if kind == "llama3":
        assert t.eos_id == t._tok.tok.token_to_id("<|end_of_text|>")  # the config's eos


@pytest.mark.parametrize("text", TEXTS)
def test_encode_and_decode(pair, text):
    _kind, t, j = pair
    for add_bos in (False, True):
        assert t.encode(text, add_bos=add_bos) == j.encode(text, add_bos=add_bos)
    ids = t.encode(text)
    assert t.encode_with_specials(text) == j.encode_with_specials(text)
    assert t.decode(ids) == j.decode(ids)
    framed = t.encode_with_specials(text) + [t.eos_id]
    assert t.decode(framed) == j.decode(framed)


def test_clean_up_tokenization_spaces_as_the_config_says(pair):
    kind, t, j = pair
    text = "I do n't know , ok ?"
    ids = t.encode(text)
    assert t.decode(ids) == j.decode(ids)
    cleaned = kind in ("sentencepiece", "llama3")
    assert (t.decode(ids) == "I don't know, ok?") == cleaned
    assert (t.decode(ids) == text) == (not cleaned)


def test_incremental_decoder_pieces(pair):
    kind, t, j = pair
    ids = t.encode(STREAM) + [t.eos_id]
    tdec, jdec = ttok.IncrementalDecoder(t), jtok.IncrementalDecoder(j)
    t_pieces = [tdec.push(i) for i in ids] + [tdec.flush()]
    j_pieces = [jdec.push(i) for i in ids] + [jdec.flush()]
    assert t_pieces == j_pieces
    # the SentencePiece decoder strips a piece's leading space, in both
    # packages alike
    assert "".join(t_pieces) == (STREAM.replace(" ", "") if kind == "sentencepiece"
                                 else STREAM)
    assert not any("�" in p for p in t_pieces)


def _walk(tv, jv, target: str) -> int:
    """Walk the grammar along ``target``: at each state the masks must be
    equal, then the allowed token whose text is the longest prefix of what
    is left is taken. Returns the number of states compared."""
    t_state = j_state = tv.dfa.start
    left, steps = target, 0
    while True:
        t_allowed, t_eos, t_ends = tv.mask(t_state)
        j_allowed, j_eos, j_ends = jv.mask(j_state)
        np.testing.assert_array_equal(t_allowed, j_allowed)
        np.testing.assert_array_equal(t_ends, j_ends)
        assert t_eos == j_eos
        steps += 1
        if not left:
            assert t_eos
            return steps
        best = max((i for i in np.flatnonzero(t_allowed)
                    if tv.token_strs[i] and left.startswith(tv.token_strs[i])),
                   key=lambda i: len(tv.token_strs[i]), default=None)
        assert best is not None, (target, left)
        left = left[len(tv.token_strs[best]):]
        t_state, j_state = tv.advance(t_state, int(best)), jv.advance(j_state, int(best))
        assert t_state == j_state


def test_token_texts_and_grammar_masks(pair):
    kind, t, j = pair
    texts = tcon.token_texts(t)
    assert texts == jcon.token_texts(j)
    assert len(texts) == t.vocab_size
    if kind == "sentencepiece":
        # byte-fallback pieces give their byte, the space marker a space
        assert texts[3 + ord("A")] == "A" and texts[t._tok.tok.token_to_id("▁too")] == " too"
    if kind == "llama3":
        assert texts[t._tok.tok.token_to_id("<|eot_id|>")] == ""
    tv, jv = tcon.GrammarVocab.for_tokenizer(t), jcon.GrammarVocab.for_tokenizer(j)
    assert tv.token_strs == jv.token_strs and tv.eos_id == jv.eos_id
    assert sum(_walk(tv, jv, target) for target in WALKS) > 10


def test_get_tokenizer_dispatch(tmp_path):
    _bytelevel(tmp_path)
    assert isinstance(ttok.get_tokenizer(""), ttok.ByteTokenizer)
    assert isinstance(ttok.get_tokenizer(str(tmp_path)), ttok.HFTokenizer)
    assert isinstance(jtok.get_tokenizer(str(tmp_path)), jtok.HFTokenizer)


def test_refuses_a_directory_without_tokenizer_json(tmp_path):
    (tmp_path / "tokenizer_config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        ttok.HFTokenizer(str(tmp_path))


def test_refuses_without_the_tokenizers_package(tmp_path, monkeypatch):
    _bytelevel(tmp_path)
    real_import = builtins.__import__

    def no_tokenizers(name, *args, **kwargs):
        if name == "tokenizers" or name.startswith("tokenizers."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.raises(ImportError, match="tokenizers package is not installed"):
        ttok.HFTokenizer(str(tmp_path))
