"""Quickstart on the PyTorch/CUDA port: the declarative SoundscapeJob API
on synthetic ocean sound.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

One fluent expression runs the paper's full feature set -- Welch PSD,
wideband SPL, third-octave levels -- PLUS pypam-style spectrum
percentile statistics in one step per chunk (the hand-written CUDA
kernels on the card, the default; their plain PyTorch versions with
``--device cpu``), then verifies against scipy and shows how to register
a custom feature with zero engine edits.
"""
import argparse

import numpy as np
import scipy.signal as ss
import torch

from repro_torch import api, resolve_device
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; exits without a CUDA "
                         "device) or 'cpu'")
    ap.add_argument("--record-sec", type=float, default=5.0)
    a = ap.parse_args(argv)
    try:
        dev = resolve_device(a.device)
    except (RuntimeError, ValueError) as e:
        ap.error(f"--device {a.device}: {e}; pass --device cpu to run on "
                 f"the CPU")

    # 12 records at 32768 Hz (the paper's sample rate)
    p = DepamParams(nfft=256, window_size=256, window_overlap=128,
                    record_size_sec=a.record_sec)
    m = DatasetManifest(n_files=3, records_per_file=4,
                        record_size=p.record_size, fs=p.fs, seed=0)

    print(f"registered features: {', '.join(api.feature_names())}")

    # ---- the whole DEPAM workload, one pass, one step a chunk ----
    result = (api.job(m, p)
              .features("welch", "spl", "tol", "percentiles")
              .chunk(4)
              .device(dev)
              .run())

    welch = result["welch"]
    ltsa_db = 10 * np.log10(np.maximum(welch, 1e-30))

    # cross-check record 0 against scipy (the paper's equivalence test)
    rec = api.sources.synth_record(0, m, dev).cpu().numpy()
    _, ref = ss.welch(rec, fs=p.fs, window=p.window,
                      nperseg=p.window_size, noverlap=p.window_overlap,
                      nfft=p.nfft, detrend=False, scaling="density")
    rel = np.abs(welch[0] - ref).max() / ref.max()

    print(f"device: {dev}")
    print(f"LTSA matrix: {ltsa_db.shape} (records x freq bins)")
    print(f"SPL per record (dB): "
          f"{np.array2string(result['spl'], precision=1)}")
    print(f"TOL bands: {result['tol'].shape[1]}; "
          f"percentiles {result['percentiles'].shape} "
          f"(records x {len(api.SPECTRUM_PERCENTILES)} x bins)")
    print(f"epoch mean spectrum: {result['mean_welch'].shape}, "
          f"job-vs-scipy max rel err: {rel:.2e}")
    assert rel < 1e-4, rel

    # ---- the pipelined executor: same job, overlapped IO/compute ----
    pipelined = (api.job(m, p)
                 .features("welch", "spl", "tol", "percentiles")
                 .chunk(4)
                 .async_io(depth=2)
                 .device(dev)
                 .run())
    assert np.array_equal(pipelined["welch"], welch)   # bitwise-equal
    print("async_io(depth=2) run is bitwise-identical to the sync run")

    # ---- extensibility: a new workload is just a registry entry ----
    zcr = api.FeatureSpec(
        name="zcr", shape=lambda m, p: (),
        compute=lambda ctx: torch.mean(
            (ctx.records[..., 1:] * ctx.records[..., :-1] < 0)
            .to(torch.float32), dim=-1),
        doc="Zero-crossing rate per record.")
    custom = api.job(m, p).features("spl", zcr).chunk(4).device(dev).run()
    print(f"custom 'zcr' feature (no engine edits): "
          f"{np.array2string(custom['zcr'], precision=3)}")


if __name__ == "__main__":
    main()
