"""What the benchmark's modules import, checked in fresh processes: no
module of ``bench/`` loads JAX or the JAX package (top-level names compared
whole: ``repro_torch`` begins with ``repro``), and the reference loads
nothing of the program nor names it in its sources."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules() -> list[Path]:
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _loaded_after(paths: list[Path]) -> set[str]:
    """Top-level names in ``sys.modules`` after loading ``paths`` by path."""
    code = f"""
import importlib.util, json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
for i, p in enumerate({[str(p) for p in paths]!r}):
    spec = importlib.util.spec_from_file_location(f"m{{i}}", p)
    sys.modules[spec.name] = mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_module_of_bench_loads_jax_or_the_jax_package():
    loaded = _loaded_after(_modules())
    assert "repro_torch" in loaded          # the program itself is loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(sorted((BENCH / "reference").glob("*.py")))
    assert "repro_torch" not in loaded
    assert not loaded & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_names_nothing_of_the_program(path):
    """No import of the program or of the benchmark's entry into it, and no
    name of the program's plain versions, oracles or test helpers."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN | {"repro_torch", "tests"}, n
            assert not n.startswith(("bench.program", "bench.kinds")), n
    text = path.read_text()
    for word in ("repro_torch", "_ref(", "attention_ref", "decode_attention_ref"):
        assert word not in text, word
