"""HuggingFace safetensors Llama checkpoint -> the port's stacked tree.

The counterpart of the JAX package's ``checkpoints/hf_loader.py``: the same
tensor names, the same shard glob (every ``*.safetensors`` of the directory
in sorted order; an index JSON is not read), the same ``config.json`` keys
checked with the same message, the same tied-head rule and the same output
tree (``models/llama.py``'s stacked layout: every per-layer HF ``[out,
in]`` weight transposed to ``[in, out]`` and stacked on a leading layer
axis).

Streamed. Shards are memory-mapped by the port's own reader
(``safetensors_io``: no HuggingFace package), and each stacked leaf is
allocated once on ``device`` in ``config.dtype``. Layer by layer, the HF
tensor is mapped on its own, copied to the device in its stored dtype,
transposed there, cast (round to nearest even, as ``jnp.asarray(...,
dtype)``) and written into its slice, then unmapped: the host holds one
tensor's pages at a time. A bf16 checkpoint is read as
bf16, never through fp32. With ``quant="int8"`` / ``"int4"`` each matmul
leaf (``models/quant.should_quantize``) goes through ``quantize_stacked``
as soon as it is complete, before the next leaf exists: the device holds
the quantized tree plus one full-precision leaf, the same numerics as
quantizing after a full load.

Mixtral checkpoints (``n_experts`` > 0): ``block_sparse_moe.gate`` becomes
the fp32 router ``[L, D, E]``, ``block_sparse_moe.experts.{e}.w1/w3/w2``
the expert leaves ``moe_gate``/``moe_up``/``moe_down`` ``[L, E, in, out]``
(each ``[out, in]`` tensor transposed), as the JAX loader stacks them; a
``config.json`` without ``num_local_experts`` is refused with the JAX
loader's message. With ``quant`` an expert leaf is built and quantized one
layer's ``[E, in, out]`` slice at a time: the device holds the quantized
tree plus one layer's full-precision experts, never a whole expert leaf
(28 GiB in bf16 for mixtral-8x7b).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import torch

from finchat_tpu_torch.checkpoints.safetensors_io import ShardIndex
from finchat_tpu_torch.models.llama import LlamaConfig, check_experts
from finchat_tpu_torch.models.quant import (
    quantize_stacked,
    should_quantize,
    validate_quant_mode,
    write_slice,
)
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def check_hf_config(path: Path, expected: dict[str, Any], n_experts: int = 0) -> None:
    """``config.json`` (where the directory has one) against our config:
    a key present in both must agree, and an MoE config (``n_experts``)
    needs an MoE checkpoint."""
    cfg_file = path / "config.json"
    if not cfg_file.exists():
        return
    hf_cfg = json.loads(cfg_file.read_text())
    for hf_key, ours in expected.items():
        if hf_key in hf_cfg and hf_cfg[hf_key] != ours:
            raise ValueError(
                f"checkpoint {hf_key}={hf_cfg[hf_key]} != config {ours}; wrong preset?")
    if n_experts and "num_local_experts" not in hf_cfg:
        raise ValueError(
            f"config expects an MoE checkpoint (n_experts={n_experts}) but config.json has no "
            "num_local_experts")


def _copy_in(dst: torch.Tensor, src: torch.Tensor, transpose: bool) -> None:
    """``dst[...] = src(.T)`` cast to ``dst.dtype``: ``src`` (a host view)
    copied to ``dst``'s device in its own dtype, transposed and cast there."""
    s = src.to(dst.device)
    dst.copy_(s.t() if transpose else s)


def load_llama_params(checkpoint_dir: str | Path, config: LlamaConfig, *,
                      device: str | torch.device = "cuda", quant: str = "",
                      quant_group: int = 0, leaf_transform: Any = None) -> dict[str, Any]:
    """Load HF Llama weights into the stacked tree on ``device``;
    ``quant``/``quant_group`` quantize each matmul leaf at load;
    ``leaf_transform(name, leaf)`` then takes each leaf but the experts'
    as soon as it is loaded (``parallel/sharding.leaf_sharder`` cuts a
    tensor-parallel rank's slice there)."""
    check_experts(config)
    validate_quant_mode(quant)
    path = Path(checkpoint_dir)
    device = torch.device(device)
    tensors = ShardIndex(path)
    logger.info("mapped %d tensors from %s", len(tensors), path)
    check_hf_config(path, {
        "hidden_size": config.dim,
        "num_hidden_layers": config.n_layers,
        "num_attention_heads": config.n_heads,
        "num_key_value_heads": config.n_kv_heads,
        "intermediate_size": config.hidden_dim,
        "vocab_size": config.vocab_size,
        "num_local_experts": config.n_experts,  # Mixtral-family
        "num_experts_per_tok": config.top_k_experts,
    }, n_experts=config.n_experts)
    L, E = config.n_layers, config.n_experts

    def finish(name: str, leaf: torch.Tensor) -> Any:
        if quant and should_quantize(name):
            leaf = quantize_stacked(leaf, mode=quant, group_size=quant_group)
        return leaf_transform(name, leaf) if leaf_transform is not None else leaf

    def single(name: str, hf_name: str, transpose: bool = False) -> Any:
        def fill(src: torch.Tensor) -> torch.Tensor:
            shape = tuple(reversed(src.shape)) if transpose else tuple(src.shape)
            leaf = torch.empty(shape, dtype=config.dtype, device=device)
            _copy_in(leaf, src, transpose)
            return leaf

        return finish(name, tensors.read(hf_name, fill))

    def stack(name: str, fmt: str, transpose: bool = True,
              dtype: torch.dtype | None = None) -> Any:
        leaf = None

        def fill(src: torch.Tensor, i: int) -> None:
            nonlocal leaf
            if leaf is None:
                shape = tuple(reversed(src.shape)) if transpose else tuple(src.shape)
                leaf = torch.empty((L,) + shape, dtype=dtype or config.dtype, device=device)
            _copy_in(leaf[i], src, transpose)

        for i in range(L):
            tensors.read(fmt.format(i=i), lambda src: fill(src, i))
        return finish(name, leaf)

    def experts(w: str) -> Any:
        # one layer's [E, in, out] slice on the device at a time; with
        # ``quant`` each expert of it quantized straight into the leaf before
        # the next layer's is read
        leaf = part = None

        def fill(src: torch.Tensor, e: int) -> None:
            nonlocal part
            if part is None:
                part = torch.empty((E,) + tuple(reversed(src.shape)), dtype=config.dtype,
                                   device=device)
            _copy_in(part[e], src, True)

        for i in range(L):
            part = None
            for e in range(E):
                tensors.read(f"model.layers.{i}.block_sparse_moe.experts.{e}.{w}.weight",
                             lambda src: fill(src, e))
            if not quant:
                leaf = write_slice(leaf, i, (L,), part)
                continue
            for e in range(E):
                leaf = write_slice(leaf, (i, e), (L, E),
                                   quantize_stacked(part[e], mode=quant, group_size=quant_group))
        return leaf

    try:
        params: dict[str, Any] = {
            "embed": single("embed", "model.embed_tokens.weight"),
            "layers": {
                "attn_q": stack("attn_q", "model.layers.{i}.self_attn.q_proj.weight"),
                "attn_k": stack("attn_k", "model.layers.{i}.self_attn.k_proj.weight"),
                "attn_v": stack("attn_v", "model.layers.{i}.self_attn.v_proj.weight"),
                "attn_o": stack("attn_o", "model.layers.{i}.self_attn.o_proj.weight"),
                "ln_attn": stack("ln_attn", "model.layers.{i}.input_layernorm.weight",
                                 transpose=False),
                "ln_mlp": stack("ln_mlp", "model.layers.{i}.post_attention_layernorm.weight",
                                transpose=False),
            },
            "norm": single("norm", "model.norm.weight"),
        }
        if E:
            # Mixtral: the router (fp32 whatever the model dtype: routing is
            # precision-sensitive), then w1/w3/w2 (gate/up/down) of every expert
            params["layers"].update({
                "router": stack("router", "model.layers.{i}.block_sparse_moe.gate.weight",
                                dtype=torch.float32),
                "moe_gate": experts("w1"),
                "moe_up": experts("w3"),
                "moe_down": experts("w2"),
            })
        else:
            params["layers"].update({
                "mlp_gate": stack("mlp_gate", "model.layers.{i}.mlp.gate_proj.weight"),
                "mlp_up": stack("mlp_up", "model.layers.{i}.mlp.up_proj.weight"),
                "mlp_down": stack("mlp_down", "model.layers.{i}.mlp.down_proj.weight"),
            })
        # tied embeddings (TinyLlama and Llama-3.2 style) ship no lm_head
        head = "lm_head.weight" if "lm_head.weight" in tensors else "model.embed_tokens.weight"
        params["lm_head"] = single("lm_head", head, transpose=True)
    finally:
        tensors.close()
    logger.info("loaded llama params: %d layers, dim %d%s", L, config.dim,
                f", {quant} at load" if quant else "")
    return params
