"""The PyTorch port stands alone: no module of it imports JAX, Flax, Optax or
the JAX package, and every module imports on a machine without a CUDA
toolkit (kernels are built and loaded only when a CUDA tensor first needs
one)."""

import ast
import importlib
import pathlib

import pytest

PORT = pathlib.Path(__file__).resolve().parents[1] / "xhy_flash_attention_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "xhy_flash_attention_tpu"}
MODULES = sorted(PORT.rglob("*.py"))


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in MODULES}
    assert {"ops/layer_norm.py", "ops/flash_attention/fwd.py",
            "ops/flash_attention/fused_heads.py",
            "ops/flash_attention/decode_kernel.py", "models/gpt.py",
            "utils/generation.py"} <= names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(PORT).as_posix())
def test_no_jax_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & FORBIDDEN, sorted(roots & FORBIDDEN)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(PORT).as_posix())
def test_module_imports_without_cuda(path):
    rel = path.relative_to(PORT.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    importlib.import_module(".".join(parts))
