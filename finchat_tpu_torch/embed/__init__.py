from finchat_tpu_torch.embed.batcher import EmbedMicrobatcher
from finchat_tpu_torch.embed.encoder import (
    EMBED_PRESETS,
    BertConfig,
    EmbeddingEncoder,
    bert_params_from_numpy,
    init_bert_params,
)
from finchat_tpu_torch.embed.index import DeviceVectorIndex, QuerySpec, VectorPoint

__all__ = [
    "BertConfig",
    "EMBED_PRESETS",
    "EmbedMicrobatcher",
    "EmbeddingEncoder",
    "bert_params_from_numpy",
    "init_bert_params",
    "DeviceVectorIndex",
    "QuerySpec",
    "VectorPoint",
]
