"""The port stands alone: no module of rtap_tpu_torch/, and not
chip_smoke.py, imports jax or anything of the JAX package rtap_tpu (an AST
scan, so imports inside functions count too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "rtap_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "rtap_tpu")


def _banned(mod: str) -> bool:
    return any(mod == b or mod.startswith(b + ".") for b in BANNED)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "rtap_tpu_torch/ops/tm_learn.py",
            "rtap_tpu_torch/service/registry.py", "rtap_tpu_torch/service/loop.py",
            "rtap_tpu_torch/service/alerts.py", "rtap_tpu_torch/service/checkpoint.py",
            "rtap_tpu_torch/service/sources.py", "rtap_tpu_torch/service/shardpath.py",
            "rtap_tpu_torch/resilience/journal.py", "rtap_tpu_torch/resilience/policies.py",
            "rtap_tpu_torch/obs/metrics.py", "rtap_tpu_torch/obs/watchdog.py",
            "rtap_tpu_torch/obs/health.py", "rtap_tpu_torch/ops/health.py",
            "rtap_tpu_torch/ops/predict.py", "rtap_tpu_torch/predict/horizon.py",
            "rtap_tpu_torch/predict/blast.py", "rtap_tpu_torch/correlate/topology.py",
            "rtap_tpu_torch/correlate/incidents.py", "rtap_tpu_torch/eval/fault_eval.py",
            "rtap_tpu_torch/predict_eval.py", "rtap_tpu_torch/ops/classifier.py",
            "rtap_tpu_torch/models/likelihood.py", "rtap_tpu_torch/models/htm_model.py",
            "rtap_tpu_torch/data/nab_corpus.py", "rtap_tpu_torch/nab/scorer.py",
            "rtap_tpu_torch/nab/runner.py", "rtap_tpu_torch/eval/workload_eval.py",
            "rtap_tpu_torch/eval/node_eval.py", "rtap_tpu_torch/eval/heldout_eval.py",
            "rtap_tpu_torch/eval/report.py", "rtap_tpu_torch/ingest/templates.py",
            "rtap_tpu_torch/ingest/__init__.py", "rtap_tpu_torch/data/synthetic.py"} <= names
    assert "rtap_tpu_torch/eval/lead_time.py" not in names  # folded into eval/fault_eval.py


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
