"""Nothing under ``portbench/`` imports JAX or the JAX package, compared
by whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from tiny import ROOT

JAX = {"jax", "jaxlib", "flax", "factorized_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name):
    return name.split(".")[0]


def test_no_file_imports_jax():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert files
    found = {(str(p.relative_to(ROOT)), m) for p in files
             for m in _imports(p) if _top(m) in JAX}
    assert not found


def test_the_whole_name_is_compared():
    assert _top("factorized_tpu_torch.trainers") not in JAX
    assert _top("factorized_tpu.trainers") in JAX


def test_reference_imports_nothing_of_the_program():
    for p in sorted((ROOT / "portbench" / "reference").rglob("*.py")):
        assert not any(_top(m) in JAX | {"factorized_tpu_torch"}
                       for m in _imports(p)), p
    code = ("import sys; import portbench.reference.steps, "
            "portbench.harness.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'factorized_tpu', "
            "'factorized_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
