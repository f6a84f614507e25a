"""What the benchmark loads: neither JAX nor the JAX package ``repro`` (by
whole top-level name: ``repro_torch`` is not ``repro``), and nothing of the
program in its plain references."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"

GUARD = r"""
import importlib.util, json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
spec = importlib.util.spec_from_file_location("bench_run", root / "bench/run.py")
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
from bench import harness
for kind in ("traffic", "metrics", "roofline", "reference", "probes"):
    for path in sorted((root / "bench" / kind).glob("*.py")):
        module = harness.load_module(kind, path.stem)
        if kind == "probes":
            module.install(harness.Launches())()
import repro_torch.launch.steps, repro_torch.launch.scheduler
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps(tops))
"""


def test_no_jax_nor_the_jax_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", GUARD, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def _imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_references_import_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imported(path):
            top = name.split(".")[0]
            assert top not in ("repro_torch", "repro", "jax", "jaxlib",
                               "flax"), f"{path.name} imports {name}"
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "from bench import harness; "
            "[harness.load_module('reference', p) for p in sys.argv[2:]]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT),
                          *(p.stem for p in files)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "repro_torch" not in out.stdout and "'repro'" not in out.stdout
