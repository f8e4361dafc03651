"""No module that a run loads has the top-level name jax, jaxlib, flax or
seeme_tpu (whole names: the port, seeme_tpu_torch, is allowed), and the
reference loads nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness, registry

PACKAGE = Path(registry.PACKAGE)


def imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_import_no_jax():
    for path in PACKAGE.rglob("*.py"):
        assert not imported_roots(path) & set(harness.BANNED), path


def test_reference_sources_import_no_port():
    for path in (PACKAGE / "reference").glob("*.py"):
        assert "seeme_tpu_torch" not in imported_roots(path), path


def test_banned_names_compare_whole():
    sys.modules.setdefault("seeme_tpu_torch", __import__("seeme_tpu_torch"))
    assert "seeme_tpu" not in harness.banned_modules()


RUN = """
import sys, json
sys.path.insert(0, {root!r})
import pytest
from portbench import harness, registry
from portbench.tests.small import SEED, shrink
mp = pytest.MonkeyPatch()
shrink(mp)
harness.run_cell({cell!r}, SEED, 0.05, True, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = """
import sys, json
sys.path.insert(0, {root!r})
from portbench import registry
for name in {configs!r}:
    registry.reference(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code: str):
    import json

    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    root = str(registry.ROOT)
    for cell in ("egobody.test.fresh", "humanml3d.test"):
        roots = loaded(RUN.format(root=root, cell=cell))
        assert "seeme_tpu_torch" in roots
        assert not roots & set(harness.BANNED), roots & set(harness.BANNED)


def test_the_reference_loads_no_port():
    configs = [c["name"] for c in registry.benchmark()["configs"]]
    roots = loaded(REF.format(root=str(registry.ROOT), configs=configs))
    assert not roots & {"seeme_tpu_torch", *harness.BANNED}
