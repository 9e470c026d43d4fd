"""The port and chip_smoke.py import neither JAX nor the JAX package."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "meta_interpolation_tpu")
PORT_FILES = sorted((ROOT / "meta_interpolation_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# the modules of the slice that ported the rest of the JAX package: each
# is a file of the port, checked above, and imports on its own
REST = ["legacy/__init__.py", "legacy/trainers.py", "legacy/driver.py",
        "legacy/train_sepconv.py", "legacy/train_voxelflow.py",
        "legacy/train_superslomo.py", "legacy/train_dain.py",
        "data/native/__init__.py", "utils/lpips.py", "utils/profiling.py",
        "utils/pyconfig.py", "ops/adaptive_weight.py"]


@pytest.mark.parametrize("rel", REST)
def test_rest_of_the_package_is_covered(rel):
    import importlib
    path = ROOT / "meta_interpolation_tpu_torch" / rel
    assert path in PORT_FILES
    module = "meta_interpolation_tpu_torch." + rel[:-3].replace(
        "/", ".").removesuffix(".__init__")
    assert importlib.import_module(module).__file__ == str(path)


def test_native_source_is_the_ports_own():
    src = ROOT / "meta_interpolation_tpu_torch" / "data" / "native" / "prep.cpp"
    assert "extern \"C\"" in src.read_text()
