#!/usr/bin/env python3
"""Digests of the event logs of the PyTorch/CUDA port's detection path.

Run on a machine with a CUDA GPU, from the root of a checkout:

    python3 scripts/torch_event_log_digest.py [--src DIR] [--label NAME]

``--src`` names the ``src/`` directory whose ``repro_torch`` runs
(default: this checkout's), so that two trees can be compared, one
process each.  It writes ``chip_smoke.py``'s detection corpus (one
45-minute wav file per paper parameter set, with its seeded bursts)
under ``build/``, runs ``chip_smoke.py``'s detection job on it for both
sets x {float32, int16}, and prints for each job the number of events
and the sha256 of its event logs (the counts and the rows, onset,
duration, peak bin and peak dB, of ``events`` and ``impulsive``), then
the card's name and power limit and one JSON line.  Two trees that
print the same digests wrote the same event logs bit for bit.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("runs the detection path on a CUDA GPU: "
                         "torch.cuda.is_available() is False")
    import chip_smoke
    from repro_torch import api
    from repro_torch.core.params import PARAM_SET_1, PARAM_SET_2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    (ROOT / "build").mkdir(exist_ok=True)
    digests = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, p in (("set1", PARAM_SET_1), ("set2", PARAM_SET_2)):
            m, pcm, _scales = chip_smoke.paper_file(p)
            root = str(Path(tmp) / name)
            chip_smoke.write_detection_wav(root, p, m, pcm)
            for payload in ("float32", "int16"):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    res = chip_smoke.detection_job(api, name, p, m, root,
                                                   payload).run()
                h = hashlib.sha256()
                for key in sorted(res.events):
                    log = res.events[key]
                    h.update(key.encode())
                    h.update(np.ascontiguousarray(log.counts).tobytes())
                    h.update(np.ascontiguousarray(log.rows).tobytes())
                job = f"{name} {payload}"
                digests[job] = {"events": int(res.events["events"].n_events),
                                "sha256": h.hexdigest()}
                print(f"{args.label}: {job}: {digests[job]['events']} events, "
                      f"event logs sha256 {digests[job]['sha256']}")
    print(smi)
    print(json.dumps({"label": args.label, "card": smi,
                      "event_logs": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
