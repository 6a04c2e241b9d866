"""PyTorch port vs the JAX package: the held-out eval.

The port's ``eval/heldout_eval.py`` against the JAX package's
``scripts/heldout_eval.py`` (loaded from its file): the variant table and
configs, the summary and verdict over seeded cells, one cell's run at 3
streams x 850 ticks on the CPU, and the incremental merge into ``--out``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rtap_tpu.data.synthetic import ANOMALY_KINDS as J_KINDS
from rtap_tpu.eval import fault_eval as jf
from rtap_tpu_torch.config import ModelConfig

torch.set_num_threads(1)


def _jax_heldout_script():
    """scripts/heldout_eval.py of the JAX package, loaded as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "heldout_eval.py"
    spec = importlib.util.spec_from_file_location("_jax_heldout_eval", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_heldout_variants_and_summary_as_jax():
    from rtap_tpu_torch.eval import heldout_eval as ph

    jh = _jax_heldout_script()
    assert ph.VARIANTS == jh.VARIANTS
    for cols, k in ph.VARIANTS.values():
        assert ph._cfg(cols, k) == ModelConfig.from_dict(jh._cfg(cols, k).to_dict())
    rng = np.random.default_rng(5)
    cells = {f"{name}|mag{m:g}|seed{s}": {"f1": round(float(rng.random()), 4)}
             for name in ("preset_256col", "eighth_32col", "half_128col")
             for m in (2.0, 6.0) for s in (11, 23)}
    assert ph._summarize(cells) == jh._summarize(cells)
    assert ph._summarize(cells)["verdict"] is not None


def test_heldout_run_cell_as_jax():
    """One cell: the port's run_cell summary equals the JAX script's
    computation of that cell (32 columns, 3 streams, every kind)."""
    from rtap_tpu_torch.eval import heldout_eval as ph

    jh = _jax_heldout_script()
    want = dataclasses.asdict(jf.run_fault_eval(
        n_streams=3, length=850, kinds=J_KINDS, magnitude=4.0, cfg=jh._cfg(32, 2),
        backend="tpu", seed=23, family="heldout"))
    got = ph.run_cell("eighth_32col_k2", 4.0, 23, streams=3, length=850, device="cpu")
    assert got == {
        "f1": want["at_best"]["f1"], "recall": want["at_best"]["recall"],
        "precision": want["at_best"]["precision"], "best_threshold": want["best_threshold"],
        "best_debounce": want["best_debounce"],
        "per_kind_recall": {k: v["recall"] for k, v in want["per_kind"].items()}}


def test_heldout_main_merges_cells_into_out(tmp_path, monkeypatch, capsys):
    from rtap_tpu_torch.eval import heldout_eval as ph

    ran = []

    def fake(name, mag, seed, streams, length, device):
        ran.append((name, mag, seed, streams, length, device))
        return {"f1": 0.5 + 0.1 * len(ran)}

    monkeypatch.setattr(ph, "run_cell", fake)
    out = tmp_path / "h.json"
    argv = ["--streams", "4", "--length", "900", "--seeds", "11", "--magnitudes", "6",
            "--device", "cpu", "--out", str(out)]
    assert ph.main([*argv, "--variants", "preset_256col"]) == 0
    assert ph.main([*argv, "--variants", "preset_256col,eighth_32col"]) == 0
    assert ran == [("preset_256col", 6.0, 11, 4, 900, "cpu"), ("eighth_32col", 6.0, 11, 4, 900, "cpu")]
    rep = json.loads(out.read_text())
    assert set(rep["cells"]) == {"preset_256col|mag6|seed11", "eighth_32col|mag6|seed11"}
    assert rep["verdict"] == {"preset_mean_f1": 0.6, "col32_mean_f1": 0.7, "col32_holds": True}
    assert rep["device"] == "cpu"
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["verdict"] == rep["verdict"]
    with pytest.raises(SystemExit, match="unknown variants"):
        ph.main(["--variants", "nope"])
