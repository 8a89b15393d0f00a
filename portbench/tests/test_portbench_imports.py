"""Nothing the benchmark or its reference loads is jax, jaxlib, flax or the
JAX package ``repro`` (compared by whole top-level names: the port's
``repro_torch`` starts with ``repro``), and the reference imports nothing
of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.tests.portbench_smoke import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
HERE = ROOT / "portbench"


def imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_a_forbidden_module():
    for path in HERE.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "contextlib", "math", "torch",
                                  "portbench"}, path
    for dep in ("weights", "__init__"):
        assert "repro_torch" not in imported(HERE / f"{dep}.py")


def test_a_whole_run_loads_no_forbidden_module():
    """A smoke run of every family, its traced run and the four-rank path,
    in a fresh process: every module then loaded, by whole top-level name."""
    code = """
import json, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from portbench.tests import portbench_smoke as S
if __name__ == "__main__":
    for name in ("qwen2.5-3b.train", "mamba2-780m.train"):
        assert S.run(S.cell(name), trace=True)["correct"]
    print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and not loaded & FORBIDDEN
