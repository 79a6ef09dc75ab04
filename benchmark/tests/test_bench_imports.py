"""What the benchmark may load: never JAX or the JAX package (top-level
names compared whole, since the port's name begins with the JAX
package's), and in the reference nothing of the port either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark.core import guard, spec

MODULES = sorted(
    ".".join(p.relative_to(spec.ROOT).with_suffix("").parts)
    for p in spec.HERE.rglob("*.py")
    if "tests" not in p.parts and "." not in p.stem)


def _loaded_after(imports: list[str]) -> list[str]:
    code = ("import importlib, json, sys\n"
            f"for m in {imports!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["collide2d_tpu_torch", "collide2d_tpu_torch.cli",
                                   "jaxtyping", "flaxx"]) == []
    assert guard.forbidden_loaded(["collide2d_tpu.ops", "jax.numpy"]) == [
        "collide2d_tpu", "jax"]


def test_every_module_and_the_program_load_no_jax():
    loaded = _loaded_after([*MODULES, "collide2d_tpu_torch.cli",
                            "collide2d_tpu_torch.data.pipeline"])
    assert guard.forbidden_loaded(loaded) == []


def test_reference_imports_nothing_of_the_program():
    reference = [m for m in MODULES if m.startswith("benchmark.reference")]
    loaded = _loaded_after(reference)
    assert not [m for m in loaded if m.split(".")[0] == "collide2d_tpu_torch"]
    for path in (spec.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in {"collide2d_tpu_torch", "collide2d_tpu",
                                                  "jax", "jaxlib", "flax"}, (path, name)
