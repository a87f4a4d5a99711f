"""What the benchmark imports: never JAX or the JAX package (``sr``), and
the reference nothing of the program."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from srbench.run import FORBIDDEN, forbidden_modules

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def _sources(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.parts)


def test_no_jax_or_jax_package_anywhere():
    for path in _sources(PKG):
        bad = _top_level_imports(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in _sources(PKG / "reference"):
        names = _top_level_imports(path)
        assert "sr_torch" not in names, path
        assert names <= {"__future__", "contextlib", "importlib", "torch",
                         "srbench"}, (path, names)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module.startswith(
                    "srbench."):
                assert node.module.startswith("srbench.reference"), path


def test_forbidden_names_compared_whole():
    assert forbidden_modules(["srbench.run", "sr_torch.infer", "srx",
                              "torch"]) == []
    assert forbidden_modules(["sr.models.edsr", "jax.numpy", "flax",
                              "optax", "jaxlib"]) == sorted(
        ["sr", "jax", "flax", "optax", "jaxlib"])


def test_the_run_loads_no_jax():
    # everything a run imports, the program included, in a fresh process
    code = ("import srbench.run, srbench.harness, srbench.control, "
            "srbench.program, srbench.kinds.frames, srbench.kinds.photos, "
            "sr_torch.infer, sr_torch.models, sr_torch.utils.interop; "
            "from srbench.run import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "srbench.run", "--workload",
         "edsr_baseline_x4.reds_frames.bf16", "--seed", "1", "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; this holds the refusal without one")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_bare_checkout_of_the_benchmark_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "srbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = _run(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""
