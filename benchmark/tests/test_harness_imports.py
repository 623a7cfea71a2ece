"""Nothing under benchmark/ imports JAX or the JAX package (top-level
module names compared whole), nor the repository's other benchmarks and
scripts; the plain reference imports nothing of the port either."""

import ast
import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "hoig_tpu"}
NOT_THE_BENCHMARK = {"bench", "bench_torch", "chip_smoke", "scripts"}


def imported(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_nothing_forbidden():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    for f in files:
        got = imported(f)
        assert not got & (FORBIDDEN | NOT_THE_BENCHMARK), f
        if "reference" in f.parts:
            assert "hoig_torch" not in got, f


def test_a_rehearsal_loads_no_jax():
    """A whole CPU run in a fresh process, then every top-level name in
    sys.modules: the port and the harness load none of JAX."""
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark.lib import harness\n"
        "from benchmark.tests.conftest import TINY\n"
        "harness.run_cell('dexycb.serve_b16', 5, 0.1, False, 'cpu', overrides=TINY)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "hoig_torch" in names and not names & FORBIDDEN
