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
