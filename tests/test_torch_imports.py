"""The port stands alone: no module of rtap_tpu_torch/, and not
chip_smoke.py, imports jax or anything of the JAX package rtap_tpu, nor the
checkpoint libraries orbax, tensorstore and zstandard (the port reads orbax
checkpoints with its own ckpt_import; an AST scan, so imports inside
functions count too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "rtap_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "rtap_tpu", "orbax", "tensorstore", "zstandard")


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
            "rtap_tpu_torch/service/aot.py",
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
            "rtap_tpu_torch/ingest/__init__.py", "rtap_tpu_torch/data/synthetic.py",
            "rtap_tpu_torch/resilience/degrade.py", "rtap_tpu_torch/resilience/chaos.py",
            "rtap_tpu_torch/resilience/supervisor.py", "rtap_tpu_torch/chaos_soak.py",
            "rtap_tpu_torch/obs/trace.py", "rtap_tpu_torch/obs/flight.py",
            "rtap_tpu_torch/obs/latency.py", "rtap_tpu_torch/obs/slo.py",
            "rtap_tpu_torch/obs/expo.py", "rtap_tpu_torch/obs/selfbench.py",
            "rtap_tpu_torch/service/attribution.py", "rtap_tpu_torch/native/__init__.py",
            "rtap_tpu_torch/ingest/protocol.py", "rtap_tpu_torch/ingest/dispatch.py",
            "rtap_tpu_torch/ingest/shm.py", "rtap_tpu_torch/ingest/emit.py",
            "rtap_tpu_torch/ingest/server.py", "rtap_tpu_torch/ingest_bench.py",
            "rtap_tpu_torch/resilience/replicate.py", "rtap_tpu_torch/failover_soak.py",
            "rtap_tpu_torch/fleet_chaos.py",
            "rtap_tpu_torch/fleet/__init__.py", "rtap_tpu_torch/fleet/protocol.py",
            "rtap_tpu_torch/fleet/member.py", "rtap_tpu_torch/fleet/aggregator.py",
            "rtap_tpu_torch/fleet/stitch.py", "rtap_tpu_torch/fleet/verdict.py",
            "rtap_tpu_torch/fleet/report.py", "rtap_tpu_torch/fleet/trace.py",
            "rtap_tpu_torch/fleet/control.py", "rtap_tpu_torch/models/migrate.py",
            "rtap_tpu_torch/ckpt_import/__init__.py", "rtap_tpu_torch/ckpt_import/zstd.py",
            "rtap_tpu_torch/ckpt_import/ocdbt.py", "rtap_tpu_torch/ckpt_import/zarr.py",
            "rtap_tpu_torch/ckpt_import/orbax_tree.py"} <= names
    assert "rtap_tpu_torch/eval/lead_time.py" not in names  # folded into eval/fault_eval.py


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_no_file_names_the_jax_native_build():
    """The host C sources and their builds are the port's own: no file of
    rtap_tpu_torch/ (sources, C, docs) and not chip_smoke.py names a path
    under the JAX package's native/ directory, so nothing compiles, opens or
    loads the JAX package's sources or libraries."""
    files = [p for p in (ROOT / "rtap_tpu_torch").rglob("*")
             if p.is_file() and "_build" not in p.parts and "__pycache__" not in p.parts]
    assert {"native/jsonl_parser.c", "native/frame_walker.c"} <= \
        {p.relative_to(ROOT / "rtap_tpu_torch").as_posix() for p in files}
    jax_native = "rtap_tpu" + "/native"
    bad = [p.relative_to(ROOT).as_posix() for p in files + [ROOT / "chip_smoke.py"]
           if jax_native in p.read_text(errors="replace")
           or "rtap_tpu.native" in p.read_text(errors="replace")]
    assert not bad, f"these name the JAX package's native/ directory: {bad}"
