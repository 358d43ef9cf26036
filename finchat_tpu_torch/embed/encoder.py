"""Embedding encoder of the BERT/bge family (own copy of the JAX package's
``embed/encoder.py``, in PyTorch).

Token and position embeddings, a post-LN transformer stack, pooling (CLS
for the bge recipe, masked mean as an option), L2 normalization. The layer
semantics are HuggingFace ``BertModel``'s: biases everywhere, exact (erf)
GELU, token-type row 0 folded into the position table.

- Every matmul goes through ``models/quant.dense``: a plain weight is
  ``x @ w``; an int8 ``QTensor`` leaf (``quant="int8"``,
  ``quantize_bert_params``) reaches ``ops/dispatch.quant_matmul``, the fused
  dequant-matmul kernel on the card and ``quant_matmul_ref`` on the CPU.
- Attention is the plain ``ops/refs.mha_reference`` (bidirectional, padded
  keys masked by each text's length), the norms, GELU, pooling and the
  normalization are plain torch: the JAX package runs all of them outside
  any Pallas kernel.
- Texts are framed by the tokenizer's ``encode_with_specials`` and padded
  to a fixed bucket (32 ... 512 tokens); padded query rows are computed and
  discarded, as the JAX package computes them, so a text's embedding does
  not depend on its batch.

The encoder runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from finchat_tpu_torch.models.quant import Q4Tensor, QTensor, quantize_stacked
from finchat_tpu_torch.models.quant import dense as quant_dense
from finchat_tpu_torch.models.tokenizer import Tokenizer
from finchat_tpu_torch.ops.refs import mha_reference

# the encoder's matmul leaves, which int8 weight-only quantization covers
# (embeddings are gathers; the norms' scales and all biases stay as they are)
BERT_QUANT_LEAVES = ("qkv", "attn_out", "mlp_in", "mlp_out")


def quantize_bert_params(params: dict[str, Any]) -> dict[str, Any]:
    """Int8-quantize the encoder's stacked matmul weights with the decoder's
    ``QTensor`` machinery (per-layer ``quantize_stacked``, per-output-column
    scales). Idempotent on already-quantized trees."""
    layers = {
        name: (leaf if isinstance(leaf, (QTensor, Q4Tensor)) or name not in BERT_QUANT_LEAVES
               else quantize_stacked(leaf))
        for name, leaf in params["layers"].items()
    }
    return {**params, "layers": layers}


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 260
    dim: int = 64
    n_layers: int = 2
    n_heads: int = 4
    hidden_dim: int = 128
    max_position: int = 512
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    pooling: str = "mean"  # "mean" | "cls" (bge uses CLS)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


EMBED_PRESETS: dict[str, BertConfig] = {
    # byte-vocab debug encoder
    "bge-tiny": BertConfig(),
    # bge-base-en (BAAI/bge-base-en-v1.5): BERT-base, CLS pooling + L2 norm
    "bge-base-en": BertConfig(
        vocab_size=30_522, dim=768, n_layers=12, n_heads=12, hidden_dim=3072,
        max_position=512, pooling="cls",
    ),
}


def init_bert_params(config: BertConfig, generator: torch.Generator,
                     device: torch.device | str) -> dict[str, Any]:
    """Random weights made in the model dtype on ``device`` from
    ``generator`` (which must live there), each matmul weight and embedding
    scaled by ``fan_in ** -0.5`` as the JAX package scales them; norm scales
    are ones, biases zeros. The values differ from the JAX package's
    (another generator): tests convert a JAX tree with
    ``bert_params_from_numpy``."""
    c = config
    L, D, F = c.n_layers, c.dim, c.hidden_dim

    def rand(shape: tuple[int, ...], fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=device, dtype=c.dtype)
        return w.mul_(fan_in ** -0.5)

    def const(shape: tuple[int, ...], value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=c.dtype, device=device)

    return {
        "tok_embed": rand((c.vocab_size, D), D),
        "pos_embed": rand((c.max_position, D), D),
        "embed_ln_scale": const((D,), 1.0),
        "embed_ln_bias": const((D,), 0.0),
        "layers": {
            "qkv": rand((L, D, 3 * D), D),
            "qkv_bias": const((L, 3 * D), 0.0),
            "attn_out": rand((L, D, D), D),
            "attn_out_bias": const((L, D), 0.0),
            "ln1_scale": const((L, D), 1.0),
            "ln1_bias": const((L, D), 0.0),
            "mlp_in": rand((L, D, F), D),
            "mlp_in_bias": const((L, F), 0.0),
            "mlp_out": rand((L, F, D), F),
            "mlp_out_bias": const((L, D), 0.0),
            "ln2_scale": const((L, D), 1.0),
            "ln2_bias": const((L, D), 0.0),
        },
    }


def bert_params_from_numpy(tree: Any, device: torch.device | str) -> dict[str, Any]:
    """The JAX package's encoder tree (numpy leaves: ``jax.device_get`` of
    ``init_bert_params`` or of ``quantize_bert_params``) as the port's, bit
    for bit (``models/convert.params_from_numpy``: bf16 through its bytes,
    a JAX ``QTensor`` as the port's)."""
    from finchat_tpu_torch.models.convert import params_from_numpy

    return params_from_numpy(tree, device)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """fp32 statistics, normalized in fp32 and cast to ``x.dtype``, then
    ``* scale + bias`` in that dtype (the JAX package's order)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * scale + bias


@torch.inference_mode()
def encode_batch(params: dict[str, Any], tokens: torch.Tensor, lengths: torch.Tensor, *,
                 config: BertConfig) -> torch.Tensor:
    """Encode a right-padded batch ``tokens [B, S]`` with valid ``lengths
    [B]`` (both on the params' device) into L2-normalized fp32 embeddings
    ``[B, dim]``."""
    c = config
    B, S = tokens.shape
    x = params["tok_embed"][tokens] + params["pos_embed"][:S][None, :, :]
    x = _layer_norm(x, params["embed_ln_scale"], params["embed_ln_bias"], c.norm_eps)
    layers = params["layers"]
    for i in range(c.n_layers):
        layer = {name: leaf[i] for name, leaf in layers.items()}
        qkv = quant_dense(x, layer["qkv"]) + layer["qkv_bias"]  # [B, S, 3D]
        q, k, v = (t.reshape(B, S, c.n_heads, c.head_dim) for t in qkv.split(c.dim, dim=-1))
        attn = mha_reference(q, k, v, causal=False, kv_len=lengths)
        # contiguous rows for the matmul (the fused kernel takes no strides)
        attn = attn.reshape(B, S, c.dim).contiguous()
        x = _layer_norm(x + quant_dense(attn, layer["attn_out"]) + layer["attn_out_bias"],
                        layer["ln1_scale"], layer["ln1_bias"], c.norm_eps)
        # exact (erf) GELU in fp32, what BERT/bge checkpoints were trained with
        h = torch.nn.functional.gelu(
            (quant_dense(x, layer["mlp_in"]) + layer["mlp_in_bias"]).float(),
            approximate="none").to(x.dtype)
        x = _layer_norm(x + quant_dense(h, layer["mlp_out"]) + layer["mlp_out_bias"],
                        layer["ln2_scale"], layer["ln2_bias"], c.norm_eps)
    if c.pooling == "cls":
        pooled = x[:, 0, :].float()
    else:  # masked mean over each text's own tokens
        valid = torch.arange(S, device=tokens.device)[None, :] < lengths[:, None]
        mask = valid[:, :, None].float()
        pooled = (x.float() * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp(min=1e-9)


_BUCKETS = (32, 64, 128, 256, 512)


class EmbeddingEncoder:
    """Host side: tokenize, pad to a bucket, encode on the device.

    ``batch_size`` (``EmbedConfig.batch_size``) caps the texts of one device
    call, so a large ingest never makes one giant activation tensor.
    ``quant="int8"`` quantizes the matmul weights (``quantize_bert_params``).
    """

    def __init__(self, config: BertConfig, params: dict[str, Any], tokenizer: Tokenizer,
                 *, batch_size: int = 64, quant: str = "",
                 device: torch.device | str = "cuda"):
        if quant and quant != "int8":
            raise ValueError(f"unknown embed quant mode {quant!r} (supported: 'int8')")
        self.config = config
        self.params = quantize_bert_params(params) if quant else params
        self.quant = quant
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.device = torch.device(device)

    @property
    def dim(self) -> int:
        return self.config.dim

    def _bucket(self, n: int) -> int:
        for b in _BUCKETS:
            if n <= b and b <= self.config.max_position:
                return b
        return min(_BUCKETS[-1], self.config.max_position)

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        """Embed texts into ``[n, dim]`` fp32 numpy, one device call per
        micro-batch of ``batch_size`` texts."""
        out = np.empty((len(texts), self.dim), np.float32)
        for lo in range(0, len(texts), self.batch_size):
            out[lo: lo + self.batch_size] = self._embed_micro(texts[lo: lo + self.batch_size])
        return out

    def _embed_micro(self, texts: list[str]) -> np.ndarray:
        encode = getattr(self.tokenizer, "encode_with_specials", self.tokenizer.encode)
        ids = [encode(t)[: self.config.max_position] for t in texts]
        lengths = [max(1, len(i)) for i in ids]
        bucket = self._bucket(max(lengths))
        padded = np.zeros((len(ids), bucket), np.int64)
        for row, seq in enumerate(ids):
            padded[row, : len(seq)] = seq[:bucket]
        out = encode_batch(
            self.params, torch.from_numpy(padded).to(self.device),
            torch.tensor(lengths, dtype=torch.int64, device=self.device), config=self.config,
        )
        return out.cpu().numpy()

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]
