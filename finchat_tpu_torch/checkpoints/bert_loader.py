"""HuggingFace BERT safetensors checkpoint -> the encoder's tree.

The counterpart of the JAX package's ``checkpoints/bert_loader.py``
(bge-base-en-v1.5 and friends are plain HF ``BertModel`` checkpoints), into
the layout of ``embed/encoder.init_bert_params``:

- a ``bert.`` prefix on a tensor name is stripped;
- each layer's q/k/v projections are fused into one ``qkv [D, 3D]`` weight
  and one ``qkv_bias [3D]``;
- every HF ``Linear`` weight ``[out, in]`` is transposed to ``[in, out]``;
- token-type row 0 is folded into the position table (finetuned encoders
  run with all-zero token types), added in fp32 and then cast, as the JAX
  loader adds it;
- the pooler head is not read (bge pools CLS from the last hidden state).

The same ``config.json`` keys are checked with the same message. Shards are
read by the port's own reader; each tensor is copied to ``device`` in its
stored dtype and transposed, fused and cast there.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import torch

from finchat_tpu_torch.checkpoints.hf_loader import check_hf_config
from finchat_tpu_torch.checkpoints.safetensors_io import ShardIndex
from finchat_tpu_torch.embed.encoder import BertConfig
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def load_bert_params(checkpoint_dir: str | Path, config: BertConfig, *,
                     device: str | torch.device = "cuda") -> dict[str, Any]:
    path = Path(checkpoint_dir)
    device = torch.device(device)
    tensors = ShardIndex(path, rename=lambda name: name.removeprefix("bert."))
    logger.info("mapped %d tensors from %s", len(tensors), path)
    check_hf_config(path, {
        "hidden_size": config.dim,
        "num_hidden_layers": config.n_layers,
        "num_attention_heads": config.n_heads,
        "intermediate_size": config.hidden_dim,
        "vocab_size": config.vocab_size,
        "max_position_embeddings": config.max_position,
    })
    dtype = config.dtype

    def get(name: str) -> torch.Tensor:
        return tensors.read(name, lambda t: t.to(device, copy=True))

    def stack(fmt: str, transpose: bool = True) -> torch.Tensor:
        return torch.stack([get(fmt.format(i=i)).t() if transpose else get(fmt.format(i=i))
                            for i in range(config.n_layers)]).to(dtype)

    def stack_qkv(bias: bool) -> torch.Tensor:
        """q/k/v fused into [L, D, 3D] (weights) or [L, 3D] (biases)."""
        kind = "bias" if bias else "weight"
        rows = []
        for i in range(config.n_layers):
            parts = [get(f"encoder.layer.{i}.attention.self.{name}.{kind}")
                     for name in ("query", "key", "value")]
            rows.append(torch.cat(parts) if bias else torch.cat([p.t() for p in parts], dim=1))
        return torch.stack(rows).to(dtype)

    try:
        # token-type row 0 is added to every position (all-zero token types)
        pos = get("embeddings.position_embeddings.weight").float()
        if "embeddings.token_type_embeddings.weight" in tensors:
            pos = pos + get("embeddings.token_type_embeddings.weight")[0].float()
        params: dict[str, Any] = {
            "tok_embed": get("embeddings.word_embeddings.weight").to(dtype),
            "pos_embed": pos.to(dtype),
            "embed_ln_scale": get("embeddings.LayerNorm.weight").to(dtype),
            "embed_ln_bias": get("embeddings.LayerNorm.bias").to(dtype),
            "layers": {
                "qkv": stack_qkv(bias=False),
                "qkv_bias": stack_qkv(bias=True),
                "attn_out": stack("encoder.layer.{i}.attention.output.dense.weight"),
                "attn_out_bias": stack("encoder.layer.{i}.attention.output.dense.bias",
                                       transpose=False),
                "ln1_scale": stack("encoder.layer.{i}.attention.output.LayerNorm.weight",
                                   transpose=False),
                "ln1_bias": stack("encoder.layer.{i}.attention.output.LayerNorm.bias",
                                  transpose=False),
                "mlp_in": stack("encoder.layer.{i}.intermediate.dense.weight"),
                "mlp_in_bias": stack("encoder.layer.{i}.intermediate.dense.bias",
                                     transpose=False),
                "mlp_out": stack("encoder.layer.{i}.output.dense.weight"),
                "mlp_out_bias": stack("encoder.layer.{i}.output.dense.bias", transpose=False),
                "ln2_scale": stack("encoder.layer.{i}.output.LayerNorm.weight", transpose=False),
                "ln2_bias": stack("encoder.layer.{i}.output.LayerNorm.bias", transpose=False),
            },
        }
    finally:
        tensors.close()
    logger.info("loaded bert params: %d layers, dim %d", config.n_layers, config.dim)
    return params
