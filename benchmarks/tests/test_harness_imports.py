"""Nothing the benchmark runs loads JAX or the JAX package; the plain
reference imports nothing of the program."""

import ast
import subprocess
import sys

from tinybench import BENCH, ROOT
from harness.cell import forbidden_modules


def test_forbidden_names_are_compared_whole():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla_client": 1, "flax": 1,
            "worldrenderer_tpu": 1, "worldrenderer_tpu.ops": 1,
            "worldrenderer_tpu_torch": 1, "worldrenderer_tpu_torch.ops": 1,
            "jaxtyping": 1, "flaxen": 1, "torch": 1}
    assert forbidden_modules(mods) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla_client", "worldrenderer_tpu",
        "worldrenderer_tpu.ops"]


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
        "import worldrenderer_tpu_torch, worldrenderer_tpu_torch.baking\n"
        "import harness.cell, harness.readings, harness.roofline\n"
        "import reference.render, reference.bake\n"
        "from harness.manifest import Manifest\n"
        "m = Manifest()\n"
        "for x in m.data['per_layer'] + m.data['end_to_end']:\n"
        "    m.metric_reader(x['name'])\n"
        "for w in m.data['workloads']:\n"
        "    m.kind(m.traffic(w['traffic'])['kind'])\n"
        "print(harness.cell.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"torch", "math", "typing", "numpy", "__future__"}
    for path in (BENCH / "reference").glob("*.py"):
        for name, level in _imports(path):
            assert level > 0 or name in allowed, (path.name, name)


def test_the_harness_reads_nothing_of_the_old_benchmarks():
    banned = {"bench", "chip_smoke", "tools", "jax", "jaxlib", "flax",
              "worldrenderer_tpu"}
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for path in files:
        text = path.read_text()
        for name, level in _imports(path):
            assert level > 0 or name not in banned, (path.name, name)
        assert "chip_smoke.py\")" not in text and "open(\"bench.py" not in text
