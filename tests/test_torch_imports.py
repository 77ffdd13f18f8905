"""The port and ``chip_smoke.py`` import neither JAX nor the JAX package."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "matrixproductbp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "matrixproductbp_tpu"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    assert len(FILES) >= 15
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"matrixproductbp_tpu_torch/{m}.py" for m in (
        "factors", "ops/sumy", "models/glauber", "models/sirs",
        "models/sis_heterogeneous", "models/inference",
        "models/equilibrium", "observations", "sampling", "smc",
        "stationary", "checkpoint", "utils/misc", "utils/__init__",
        "parallel/partition", "parallel/halo", "native/__init__",
        "utils/profiling", "entry")} <= names
    assert _forbidden("jax.numpy") and _forbidden("matrixproductbp_tpu.bp")
    assert not _forbidden("matrixproductbp_tpu_torch.bp")
