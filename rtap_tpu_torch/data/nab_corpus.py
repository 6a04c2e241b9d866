"""NAB-format corpus IO and the offline stand-in corpus.

A copy of the JAX package's ``data/nab_corpus.py`` (the port keeps its own).
A NAB corpus is CSV files (``timestamp,value``, '%Y-%m-%d %H:%M:%S' UTC
stamps) under ``data/`` plus ``labels/combined_windows.json``, which maps
each relative CSV path to its [start, end] anomaly windows.

The real corpus is not in the repository; ``ensure_standin_corpus`` writes
a deterministic synthetic corpus in the same on-disk layout (the committed
``data/nab``), and ``$RTAP_NAB_CORPUS`` or an explicit root points at a real
NAB checkout once there is one.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

from rtap_tpu_torch.data.synthetic import LabeledStream, SyntheticStreamConfig, generate_stream

NAB_CORPUS_ENV = "RTAP_NAB_CORPUS"
TS_FMT = "%Y-%m-%d %H:%M:%S"

# Stand-in corpus layout: (relative name, metric profile, rows). 5-min cadence
# like real NAB. The first entry is the stream of the golden_config1 golden.
STANDIN_FILES = [
    ("realAWSCloudwatch/ec2_cpu_utilization_5f5533.csv", "cpu", 4032),
    ("realAWSCloudwatch/ec2_cpu_utilization_24ae8d.csv", "cpu", 4032),
    ("realAWSCloudwatch/ec2_network_in_257a54.csv", "net", 4032),
    ("realAWSCloudwatch/ec2_disk_write_bytes_1ef3de.csv", "disk_io", 4032),
    ("realAWSCloudwatch/rds_cpu_utilization_e47b3b.csv", "cpu", 4032),
    ("realAWSCloudwatch/elb_request_count_8c0756.csv", "net", 4032),
    ("synthetic/node_mem_leak.csv", "mem", 4032),
    ("synthetic/node_latency_burst.csv", "latency_ms", 4032),
]


@dataclass
class NabFile:
    """One corpus file: timestamps (unix sec), values, label windows."""

    name: str  # relative path, e.g. "realAWSCloudwatch/ec2_cpu_utilization_5f5533.csv"
    timestamps: np.ndarray  # int64 unix seconds [T]
    values: np.ndarray  # float32 [T]
    windows: list[tuple[int, int]]  # [(start_unix, end_unix)]


def _parse_ts(s: str) -> int:
    # NAB stamps may carry fractional seconds in labels; truncate.
    s = s.split(".")[0]
    return int(datetime.strptime(s, TS_FMT).replace(tzinfo=timezone.utc).timestamp())


def _fmt_ts(unix: int) -> str:
    return datetime.fromtimestamp(int(unix), tz=timezone.utc).strftime(TS_FMT)


def load_corpus(root: str | Path, subset: str | None = None) -> list[NabFile]:
    """Load a NAB-format corpus: root/data/**/*.csv + root/labels/combined_windows.json.

    `subset` filters by relative-path prefix (e.g. "realAWSCloudwatch").
    """
    root = Path(root)
    data_dir = root / "data"
    with open(root / "labels" / "combined_windows.json") as f:
        label_map = json.load(f)
    out: list[NabFile] = []
    for csv_path in sorted(data_dir.rglob("*.csv")):
        rel = csv_path.relative_to(data_dir).as_posix()
        if subset and not rel.startswith(subset):
            continue
        ts, vals = [], []
        with open(csv_path) as f:
            header = f.readline()  # "timestamp,value"
            assert "timestamp" in header
            for line in f:
                t_str, v_str = line.rstrip("\n").split(",")[:2]
                ts.append(_parse_ts(t_str))
                vals.append(float(v_str))
        windows = [(_parse_ts(a), _parse_ts(b)) for a, b in label_map.get(rel, [])]
        out.append(NabFile(rel, np.asarray(ts, np.int64), np.asarray(vals, np.float32), windows))
    return out


def write_corpus(root: str | Path, files: list[NabFile]) -> None:
    """Write files in NAB on-disk format (data/ CSVs + labels json)."""
    root = Path(root)
    label_map: dict[str, list[list[str]]] = {}
    for nf in files:
        p = root / "data" / nf.name
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            f.write("timestamp,value\n")
            for t, v in zip(nf.timestamps, nf.values):
                f.write(f"{_fmt_ts(t)},{v:.5f}\n")
        label_map[nf.name] = [[_fmt_ts(a), _fmt_ts(b)] for a, b in nf.windows]
    (root / "labels").mkdir(parents=True, exist_ok=True)
    with open(root / "labels" / "combined_windows.json", "w") as f:
        json.dump(label_map, f, indent=2, sort_keys=True)


def _standin_files(seed: int = 7) -> list[NabFile]:
    out = []
    for rel, metric, rows in STANDIN_FILES:
        # noise_scale keeps the stand-in as smooth as real CloudWatch series:
        # per-step noise must stay within ~1 encoder bucket (range/130) or the
        # TM never converges and anomalies drown in baseline jitter
        cfg = SyntheticStreamConfig(
            length=rows, cadence_s=300.0, metric=metric, n_anomalies=3,
            anomaly_magnitude=8.0, noise_scale=0.35,
            kinds=("spike", "level_shift", "dropout"),
        )
        ls: LabeledStream = generate_stream(rel, cfg, seed=seed)
        out.append(NabFile(rel, ls.timestamps, ls.values, ls.windows))
    return out


def ensure_standin_corpus(root: str | Path | None = None, seed: int = 7) -> Path:
    """Return a corpus root, generating the synthetic stand-in if needed.

    Resolution order: explicit `root` (always honored, for test isolation) ->
    $RTAP_NAB_CORPUS (a real NAB checkout, when one is there) ->
    <repo>/data/nab (generated stand-in, cached on disk).
    """
    if root is None:
        env = os.environ.get(NAB_CORPUS_ENV)
        if env and (Path(env) / "labels" / "combined_windows.json").exists():
            return Path(env)
        root = Path(__file__).resolve().parents[2] / "data" / "nab"
    root = Path(root)
    marker = root / "labels" / "combined_windows.json"
    if not marker.exists():
        write_corpus(root, _standin_files(seed))
    return root
