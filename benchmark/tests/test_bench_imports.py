"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the program's name begins with the JAX package's),
and the references import nothing of the program."""

import ast

import pytest

import _paths

FORBIDDEN = {"jax", "jaxlib", "flax", "comfyui_gguf_tpu"}
PROGRAM = "comfyui_gguf_tpu_torch"
# the references and what they are built from
REFERENCE = ("refops.py", "ggml.py")
SOURCES = sorted(p for p in _paths.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not FORBIDDEN & set(_imports(path))


def _is_reference(path):
    return path.name in REFERENCE or path.name.endswith("_ref.py")


@pytest.mark.parametrize("path", [p for p in SOURCES if _is_reference(p)],
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    names = set(_imports(path))
    assert PROGRAM not in names
    # and nothing of the benchmark that touches the program
    assert not names & {"program", "run", "weights"}


def test_the_references_are_found():
    names = {p.name for p in SOURCES if _is_reference(p)}
    assert {"flux_ref.py", "wan_ref.py", "refops.py", "ggml.py"} <= names
