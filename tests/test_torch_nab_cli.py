"""PyTorch port: ``run_corpus`` and ``python -m rtap_tpu_torch nab`` on the CPU.

* ``run_corpus``'s batched path (one stream group) and per-file path (an
  ``HTMModel`` per file) agree within 1e-9 (the batched likelihood's
  rounding).
* The CLI end to end on the committed stand-in corpus (truncated and
  width-scaled for CPU cost, as the JAX package's own CLI test runs it), and
  its exit 2 on a missing corpus or an empty subset.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rtap_tpu_torch.__main__ import main
from rtap_tpu_torch.config import ModelConfig
from rtap_tpu_torch.nab.runner import run_corpus
from tests.golden.generate_golden import golden_config
from tests.test_torch_nab import _mini_corpus

torch.set_num_threads(1)

CORPUS = Path(__file__).resolve().parent.parent / "data" / "nab"
CFG = ModelConfig.from_dict(golden_config().to_dict())


def test_run_corpus_per_file_and_batched_agree():
    files = _mini_corpus()
    a = run_corpus(files, CFG, device="cpu")
    b = run_corpus(files, CFG, device="cpu", batched=False)
    assert a.raw is not None and b.raw is None
    for (sa, _, _), (sb, _, _) in zip(a.per_file, b.per_file):
        np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-9)
    assert a.scores.keys() == {"standard", "reward_low_FP", "reward_low_FN"}
    # one spawned process per file: the same scores as in this process
    c = run_corpus(files, CFG, device="cpu", batched=False, processes=2)
    for (sb, _, _), (sc, _, _) in zip(b.per_file, c.per_file):
        np.testing.assert_array_equal(sb, sc)
    assert c.scores == b.scores


def test_nab_command_on_cpu(tmp_path, capsys):
    """The CLI end to end on the committed corpus, truncated and width-scaled
    for CPU cost: scores for all three profiles, the report JSON and the
    per-row detections written."""
    out, det = tmp_path / "nab.json", tmp_path / "det.npz"
    assert main(["nab", "--rows", "600", "--columns", "64", "--device", "cpu",
                 "--subset", "realAWSCloudwatch/ec2_cpu_utilization_5f5533",
                 "--out", str(out), "--detections", str(det),
                 "--save-group", str(tmp_path / "grp")]) == 0
    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(scores) == {"standard", "reward_low_FP", "reward_low_FN"}
    rep = json.loads(out.read_text())
    assert rep["records"] == 600 and rep["device"] == "cpu"
    assert rep["files"] == ["realAWSCloudwatch/ec2_cpu_utilization_5f5533.csv"]
    for prof in scores.values():
        assert -200.0 <= prof["score"] <= 100.0
    with np.load(det) as z:
        name = "realAWSCloudwatch/ec2_cpu_utilization_5f5533.csv"
        assert z[f"raw/{name}"].shape == (600,) and np.isfinite(z[f"loglik/{name}"]).all()
    # the batched group's final state, as a group checkpoint
    from rtap_tpu_torch.service.checkpoint import load_group

    grp = load_group(tmp_path / "grp", device="cpu")
    assert grp.stream_ids == [name] and grp.ticks == 600
    assert int(grp.state["tm_iter"][0]) == 600 and rep["kernel_launches"] == {"tm_learn": 0}


def test_nab_command_missing_corpus_or_subset_exits_2(tmp_path, capsys):
    assert main(["nab", "--corpus", str(tmp_path / "nowhere")]) == 2
    assert "combined_windows.json" in capsys.readouterr().err
    assert main(["nab", "--corpus", str(CORPUS), "--subset", "nothing/"]) == 2
    assert "matched no files" in capsys.readouterr().err


def test_nab_command_runs_on_cuda_unless_told(monkeypatch):
    """No card and no --device: the run refuses loudly instead of falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["nab", "--rows", "5", "--columns", "32"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_corpus(_mini_corpus(), CFG, batched=False)
