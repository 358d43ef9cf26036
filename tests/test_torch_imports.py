"""The port stands alone: no module of ``finchat_tpu_torch`` and not
``chip_smoke.py`` imports JAX, anything of the JAX package, or
``ml_dtypes`` (the card's machine has none: a bf16 host tensor is a torch
tensor), and the CUDA sources build without PyTorch's headers (plain C
interface, ``ctypes``)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "finchat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
CUDA_FILES = sorted((ROOT / "finchat_tpu_torch" / "csrc").glob("*.cu*"))


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "finchat_tpu", "ml_dtypes") or top.startswith("jax")


def test_port_files_found():
    assert len(PORT_FILES) > 15 and len(CUDA_FILES) >= 3


@pytest.mark.parametrize("module", [
    "agent/__init__.py", "agent/state.py", "agent/toolcall.py", "agent/constrained.py",
    "tools/plot.py", "utils/tracing.py", "utils/metrics.py", "engine/generator.py",
    "agent/graph.py", "agent/streamparse.py",
    "utils/config.py", "io/schemas.py", "io/store.py", "io/kafka.py", "io/journal.py",
    "serve/fleet.py", "serve/http.py", "serve/app.py",
])
def test_the_agent_planes_modules_are_walked(module):
    """The agent (its graph, the streaming tool parser), the modules it
    rides on (grammar, tool parsing, tracing, the generator) and the
    serving app with its transport, store, journal and HTTP server are
    among the files walked above."""
    assert ROOT / "finchat_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", [
    "embed/__init__.py", "embed/encoder.py", "embed/index.py", "embed/batcher.py",
    "tools/retrieval.py", "tools/qdrant_retriever.py", "__main__.py",
])
def test_the_retrieval_modules_are_walked(module):
    """The encoder, the vector index, the microbatcher, both retrievers and
    the CLI are among the files walked above (the index's reference imports
    only numpy and JAX: the port keeps its own copy)."""
    assert ROOT / "finchat_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", CUDA_FILES, ids=[p.name for p in CUDA_FILES])
def test_cuda_sources_use_plain_c_interface(path):
    text = path.read_text()
    assert "torch/extension.h" not in text and "ATen/" not in text
    if path.suffix == ".cu":
        assert 'extern "C"' in text
        # every source opens with its note: the TPU kernel it replaces
        assert "Replaces the TPU kernel finchat_tpu/ops/" in text.split("#include")[0]


@pytest.mark.parametrize("module", ["engine/spec.py", "ops/freerun.py", "engine/engine.py",
                                    "engine/scheduler.py"])
def test_the_decode_planes_modules_are_walked(module):
    """The prompt-lookup proposer and the free-run staging (numpy-only in
    the JAX package, which the port does not import: it keeps its own
    copies), and the engine and scheduler that carry the decode loop, spec
    decode and the free-running loop, are among the files walked above."""
    assert ROOT / "finchat_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["checkpoints/__init__.py", "checkpoints/safetensors_io.py",
                                    "checkpoints/hf_loader.py", "checkpoints/bert_loader.py",
                                    "checkpoints/native_io.py", "models/tokenizer.py"])
def test_the_checkpoint_modules_are_walked(module):
    """The safetensors reader and writer, both HF loaders, native
    save/restore and the tokenizers are among the files walked above."""
    assert ROOT / "finchat_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_needs_no_hf_package_but_tokenizers(path):
    """The card's machine has none of ``safetensors``, ``transformers`` and
    ``tokenizers``: the port reads and writes safetensors with its own code,
    and only ``models/tokenizer.py`` imports ``tokenizers``, inside
    ``HFTokenizer``, for a tokenizer path."""
    tops = {m.split(".")[0] for m in _imported_modules(path)}
    assert not tops & {"safetensors", "transformers", "huggingface_hub"}, path
    if "tokenizers" in tops:
        assert path == ROOT / "finchat_tpu_torch" / "models" / "tokenizer.py"


@pytest.mark.parametrize("module", ["serve/fleet.py", "serve/disagg.py", "engine/scheduler.py"])
def test_the_fleet_modules_are_walked(module):
    """The engine fleet, the disaggregation coordinator and the scheduler's
    drain plane are among the files walked above."""
    assert ROOT / "finchat_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["engine/warm_fabric.py", "serve/pod.py",
                                    "engine/session_cache.py", "io/kafka.py"])
def test_the_fleet_planes_modules_are_walked(module):
    """The warm-state fabric, the pod plane, and the session cache's and the
    broker's hooks for them are among the files walked above."""
    assert ROOT / "finchat_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["parallel/__init__.py", "parallel/mesh.py",
                                    "parallel/sharding.py", "parallel/ranks.py",
                                    "ops/tp_overlap.py"])
def test_the_parallel_modules_are_walked(module):
    """The mesh, the sharding rules, the rank protocol and the row-parallel
    collective are among the files walked above (the JAX package's
    counterparts import JAX: the port keeps its own)."""
    assert ROOT / "finchat_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["parallel/collectives.py", "parallel/pipeline.py",
                                    "train/train_step.py"])
def test_the_parallel_training_modules_are_walked(module):
    """The differentiable collectives, the stage pipeline and the mesh train
    step are among the files walked above (the JAX package's pipeline and
    train step import JAX and optax: the port keeps its own)."""
    assert ROOT / "finchat_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["ops/ring_attention.py", "ops/ulysses.py",
                                    "parallel/collectives.py", "engine/engine.py"])
def test_the_sequence_parallel_modules_are_walked(module):
    """Ring and Ulysses attention, the sequence collectives and the engine's
    seq-sharded prefill are among the files walked above (the JAX package's
    ops import JAX: the port keeps its own)."""
    assert ROOT / "finchat_tpu_torch" / module in PORT_FILES
