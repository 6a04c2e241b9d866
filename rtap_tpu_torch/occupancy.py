"""How full the TM pools are after T learning ticks, and what share of a
learning pass's rows needs its perm or changes.

    python -m rtap_tpu_torch.occupancy [--device cpu]

A ``cluster_preset`` group of 12 streams learns the replay's synthetic
cluster data (seed 0, ``chunk_step`` as the replay does); after T = 128,
300 and 900 learning ticks it prepares the next learning tick's pass
(``ops/step.next_learn_pass``) and runs it on a copy of the pools. Prints
one JSON line per T with ``ops/tm_learn.pass_occupancy``: these are counts,
the same on any device, and they set which bytes the pass must move
(``pass_bytes``). Runs on cuda unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

STREAMS = 12
TICKS = (128, 300, 900)
SEED = 0


def main(argv=None) -> int:
    from rtap_tpu_torch import resolve_device
    from rtap_tpu_torch.config import cluster_preset
    from rtap_tpu_torch.data.synthetic import cluster_streams
    from rtap_tpu_torch.models.state import init_state
    from rtap_tpu_torch.ops.step import chunk_step, next_learn_pass, replicate_state_device
    from rtap_tpu_torch.ops.tm_learn import pass_occupancy, tm_learn_kernel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = cluster_preset()
    streams = cluster_streams(STREAMS, TICKS[-1] + 1, SEED, n_anomalies=0)
    vals = torch.from_numpy(np.stack([s.values for s in streams], 1)[:, :, None]).to(dev)
    ts = torch.from_numpy(np.stack([s.timestamps for s in streams], 1).astype(np.int32)).to(dev)
    st = replicate_state_device(init_state(cfg, SEED), STREAMS, dev)
    done = 0
    for T in TICKS:
        st, _ = chunk_step(st, vals[done:T], ts[done:T], cfg)
        done = T
        lp = next_learn_pass(cfg, st, vals[T], ts[T])
        after = [a.clone() for a in lp.args[:2]]
        tm_learn_kernel(*after, *lp.args[2:], lp.consts, lp.K, lp.N)
        print(json.dumps({"preset": "cluster_preset", "streams": STREAMS, "learning_ticks": T,
                          "device": str(dev), **pass_occupancy(lp.args, *after)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
