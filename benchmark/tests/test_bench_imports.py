"""The whole-name import check, and a reference that imports nothing of
the program."""

import ast
import os
import sys

from benchmark import harness
from benchmark.spec import HERE


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rigid_body_light_tpu_torch.fake",
                        sys.modules[__name__])
    assert "rigid_body_light_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rigid_body_light_tpu.ops",
                        sys.modules[__name__])
    monkeypatch.setitem(sys.modules, "jax", sys.modules[__name__])
    assert harness.forbidden_modules() == ["jax", "rigid_body_light_tpu"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert not tops & {"rigid_body_light_tpu_torch",
                               "rigid_body_light_tpu", "jax"}, name


def test_harness_sources_name_no_jax():
    for dirpath, _, files in os.walk(HERE):
        if os.sep + "tests" in dirpath:
            continue
        for name in files:
            if name.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(dirpath, name))}
                assert not tops & set(harness.FORBIDDEN), name
