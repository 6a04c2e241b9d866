"""PyTorch port: the visualization report (``python -m rtap_tpu_torch report``).

* ``report_data`` replays the JAX package's ``scripts/report.py`` streams:
  the same streams, raw scores, log-likelihood and alerts as the JAX
  ``replay_streams`` on them.
* The command writes ``overlay.png`` and ``fault_eval.png`` on the CPU at
  2 streams x 850 ticks, checked as ``tests/integration/test_report.py``
  checks the JAX script's (PNG magic, sizes).
* Importing the module needs no matplotlib (it is imported to render).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rtap_tpu.config import cluster_preset as j_cluster_preset
from rtap_tpu.data.synthetic import SyntheticStreamConfig as JSynCfg
from rtap_tpu.data.synthetic import generate_stream as j_generate_stream
from rtap_tpu.service.loop import replay_streams as j_replay
from rtap_tpu_torch.__main__ import main
from rtap_tpu_torch.eval import report

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EVAL_REPORT = {
    "at_best": {"f1": 0.72, "recall": 0.88, "precision": 0.61, "median_latency_s": 1.0},
    "per_kind": {"spike": {"recall": 0.82}, "level_shift": {"recall": 0.89},
                 "dropout": {"recall": 0.9}},
}


def test_report_data_as_jax_replay():
    streams, res = report.report_data(2, 850, device="cpu")
    base = j_cluster_preset()
    cfg = dataclasses.replace(base, likelihood=dataclasses.replace(base.likelihood, mode="window"))
    frac = cfg.likelihood.safe_inject_frac(850)
    metrics = ("cpu", "mem", "net")
    want_streams = [j_generate_stream(
        f"node{i:03d}.{metrics[i % 3]}",
        JSynCfg(length=850, metric=metrics[i % 3], n_anomalies=2,
                kinds=("spike", "level_shift", "dropout"), anomaly_magnitude=6.0,
                noise_phi=0.97, noise_scale=0.5, inject_after_frac=frac), seed=11)
        for i in range(2)]
    want = j_replay(want_streams, cfg, backend="tpu", threshold=0.39, chunk_ticks=128)
    for s, w in zip(streams, want_streams):
        np.testing.assert_array_equal(s.values, w.values)
        assert s.windows == w.windows
    np.testing.assert_array_equal(res.raw, want.raw)
    np.testing.assert_array_equal(res.log_likelihood, want.log_likelihood)
    np.testing.assert_array_equal(res.alerts, want.alerts)
    np.testing.assert_array_equal(res.timestamps, want.timestamps)
    assert res.raw.shape == (850, 2)


def test_report_command_writes_pngs(tmp_path):
    rep_path = tmp_path / "fault_eval.json"
    rep_path.write_text(json.dumps(EVAL_REPORT))
    out = tmp_path / "out"
    assert main(["report", "--device", "cpu", "--out-dir", str(out), "--streams", "2",
                 "--length", "850", "--eval-report", str(rep_path)]) == 0
    overlay, evalpng = out / "overlay.png", out / "fault_eval.png"
    assert overlay.exists() and overlay.stat().st_size > 20_000
    assert evalpng.exists() and evalpng.stat().st_size > 5_000
    assert overlay.read_bytes()[:8] == evalpng.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_report_flags_mirror_the_jax_cli():
    """The JAX CLI's report defaults (streams 6, length 900) and the
    script's own threshold and seed."""
    from rtap_tpu_torch.__main__ import build_parser

    args = build_parser().parse_args(["report"])
    assert (args.streams, args.length, args.eval_report) == (6, 900, None)
    assert args.out_dir != "reports"  # the port never writes the JAX package's artifacts
    assert (report.THRESHOLD, report.SEED) == (0.39, 11)


def test_import_needs_no_matplotlib():
    code = ("import sys; import rtap_tpu_torch.eval.report, rtap_tpu_torch.__main__; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "False"


def test_rendering_without_matplotlib_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        report.eval_figure(EVAL_REPORT)
