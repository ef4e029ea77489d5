"""imitation_tpu_torch and chip_smoke.py import nothing of JAX or of the JAX
package, nor any package the GPU machine lacks (an AST scan of every file)."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "imitation_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "imitation_tpu", "gymnasium", "gym", "mujoco",
             "datasets", "msgpack", "orbax", "chex", "tensorboardX", "wandb",
             "examples"}  # the JAX package's examples import JAX
ALLOWED_THIRD_PARTY = {"torch", "numpy"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_scan_sees_the_port():
    assert len(PORT_FILES) > 20
    assert (REPO / "imitation_tpu_torch" / "csrc" / "gae.cu").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    import sys

    bad = []
    for root, line in _imported_roots(path):
        if root in FORBIDDEN:
            bad.append(f"{root} (line {line})")
        elif root not in ALLOWED_THIRD_PARTY and root != "imitation_tpu_torch" \
                and root not in sys.stdlib_module_names and root != "__future__":
            bad.append(f"{root} (line {line}): not torch, numpy or the standard library")
    assert not bad, f"{path.name} imports {bad}"
