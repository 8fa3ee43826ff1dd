"""The port imports neither JAX nor the JAX package, nor the packages
that read the JAX package's checkpoints (``tensorstore``, ``zstandard``,
``msgpack``), which the card's machine does not have: the port reads
them with its own ``utils/zstd.py``, ``ocdbt.py``, ``zarr.py``,
``orbax.py`` and ``msgpack.py``. Every module of ``factorized_tpu_torch``
and ``chip_smoke.py`` is checked by its AST."""

import ast
import pathlib

import jax  # noqa: F401  (the test files of the port import both)
import pytest
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "orbax", "factorized_tpu",
             "tensorstore", "zstandard", "msgpack")
FILES = sorted((ROOT / "factorized_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_the_guard_sees_what_it_guards():
    assert len(FILES) > 10
    assert any(p.parent.name == "probes" for p in FILES)
    assert _forbidden("jax.numpy") and _forbidden("factorized_tpu.serve")
    assert _forbidden("tensorstore") and _forbidden("zstandard")
    assert _forbidden("msgpack")
    assert not _forbidden("factorized_tpu_torch.serve")
    assert not _forbidden("factorized_tpu_torch.utils.msgpack")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_imports(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"
