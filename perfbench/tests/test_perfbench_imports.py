"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast

import pytest

FORBIDDEN = {"jax", "jaxlib", "flax", "khmer_ocr_tpu"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(root, sub=""):
    return sorted((root / "perfbench" / sub).rglob("*.py"))


def test_no_jax_anywhere(root):
    for path in sources(root):
        assert not imported(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program(root):
    for path in sources(root, "reference"):
        assert "khmer_ocr_torch" not in imported(path), path


@pytest.mark.parametrize("name, whole", [("khmer_ocr_torch.infer", False), ("khmer_ocr_tpu.x", True),
                                         ("jaxlib", True), ("jaxtyping", False)])
def test_top_level_names_are_compared_whole(name, whole):
    from perfbench.harness.cli import FORBIDDEN as RUN_FORBIDDEN

    assert (name.split(".")[0] in RUN_FORBIDDEN) is whole
