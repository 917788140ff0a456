"""Import hygiene of the port: ``fastedit_tpu_torch`` and ``chip_smoke.py``
import neither JAX, Flax nor the JAX package ``fastedit_tpu``, and none of
``safetensors``, ``ml_dtypes``, ``tqdm`` or ``matplotlib`` (the card's
machine has none of them: the port reads and writes checkpoints with
``utils/safetensors_io.py``, and its CLIs print their own progress and draw
their figures with PIL).

Checked twice: by importing every module of the port (and ``chip_smoke``) in
a fresh interpreter and reading ``sys.modules``, and by parsing every
source file for such imports (which also covers imports inside functions
that an import alone never runs).
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "fastedit_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "fastedit_tpu", "safetensors", "ml_dtypes", "tqdm",
             "matplotlib")
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(ROOT).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    modules = [_module_name(p) for p in SOURCES]
    # ``import torch`` itself loads ``tqdm`` where it is installed
    # (``torch.hub``'s optional progress bar; torch goes without it on the
    # card's machine), so what torch loads alone is not the port's.
    code = (
        "import importlib, json, sys\n"
        "import torch\n"
        "by_torch = set(sys.modules)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps([sorted(sys.modules), sorted(by_torch)]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout
    loaded, by_torch = json.loads(out.strip().splitlines()[-1])
    assert [m for m in by_torch if _forbidden(m) and m.split(".")[0] != "tqdm"] == []
    loaded = sorted(set(loaded) - set(by_torch))
    assert "fastedit_tpu_torch.pipeline.editor" in loaded and "chip_smoke" in loaded
    for new in ("fastedit_tpu_torch.bench", "fastedit_tpu_torch.pipeline.graphs",
                "fastedit_tpu_torch.utils.flops", "fastedit_tpu_torch.metrics.calculator",
                "fastedit_tpu_torch.tools.convert_checkpoint",
                "fastedit_tpu_torch.utils.safetensors_io", "fastedit_tpu_torch.run_batch",
                "fastedit_tpu_torch.parallel.batch", "fastedit_tpu_torch.run_benchmark",
                "fastedit_tpu_torch.plotting.compare_methods", "fastedit_tpu_torch.serve",
                "fastedit_tpu_torch.tools.conformance"):
        assert new in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_import(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"
