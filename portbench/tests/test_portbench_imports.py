"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (the port's own name begins with the JAX
package's), and the reference imports nothing of the port either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import _tiny
from portbench import guard

BENCH = _tiny.ROOT / "portbench"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_in(["needletail_tpu_torch.device", "jaxtyping",
                               "numpy"]) == []
    assert guard.forbidden_in(["needletail_tpu.device", "jax.numpy",
                               "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "needletail_tpu"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = guard.forbidden_in(_imports(path))
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert names <= {"__future__", "typing", "numpy"}, (path, names)


def test_a_run_loads_no_forbidden_module():
    code = (
        "import json, sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import _tiny\n"
        "from portbench import harness\n"
        "r = _tiny.run_tiny(harness, 'spectrum31.phages', trace=True)\n"
        "harness.stop_children()\n"
        "print(json.dumps([r['correct'], sorted({m.split('.')[0] for m in sys.modules})]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(Path(__file__).resolve().parent)],
        capture_output=True, text=True, timeout=600, check=True,
    ).stdout
    correct, names = json.loads(out.strip().splitlines()[-1])
    assert correct
    assert "needletail_tpu_torch" in names
    assert guard.forbidden_in(names) == []
