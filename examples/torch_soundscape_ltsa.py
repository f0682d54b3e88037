"""Soundscape characterization with fault-tolerant resume on the
PyTorch/CUDA port -- the paper's production scenario at miniature scale,
on the SoundscapeJob API.

    PYTHONPATH=src python examples/torch_soundscape_ltsa.py [--device cpu]

1. writes a small wav dataset (the St-Pierre-et-Miquelon layout in
   miniature: N files x M records);
2. runs the job HALFWAY into a resumable store and "crashes" --
   mid-window, so the partially-filled LTSA/SPD carries ride the commit;
3. restarts the SAME job expression: the store's committed cursor
   resumes exactly where the crash happened and the windowed products
   complete bitwise-identically;
4. verifies the resumed result equals an uninterrupted run, and streams
   the same features through a callback sink (the live-monitoring
   shape).

Runs on the card by default; ``--device cpu`` runs the plain PyTorch
path.
"""
import argparse
import tempfile

import numpy as np

from repro_torch import api, resolve_device
from repro_torch.core.manifest import DatasetManifest, plan
from repro_torch.core.params import DepamParams
from repro_torch.core.store import FeatureStore
from repro_torch.data.loader import SpeculativeLoader
from repro_torch.data.wavio import WavRecordReader, write_dataset

FEATURES = ("welch", "spl", "tol", "percentiles", "ltsa", "spd", "minmax")
PER_RECORD = FEATURES[:4]
WINDOWED = ("ltsa", "spd", "min_welch", "max_welch")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; exits without a CUDA "
                         "device) or 'cpu'")
    ap.add_argument("--record-sec", type=float, default=1.0)
    a = ap.parse_args(argv)
    try:
        dev = resolve_device(a.device)
    except (RuntimeError, ValueError) as e:
        ap.error(f"--device {a.device}: {e}; pass --device cpu to run on "
                 f"the CPU")

    p = DepamParams(nfft=256, window_size=256, window_overlap=128,
                    record_size_sec=a.record_sec)
    m = DatasetManifest(n_files=4, records_per_file=6,
                        record_size=p.record_size, fs=p.fs, seed=7)

    with tempfile.TemporaryDirectory() as wav_dir, \
            tempfile.TemporaryDirectory() as store_dir:
        write_dataset(wav_dir, m)

        def soundscape_job():
            # per-record features AND the multi-resolution soundscape
            # products, one pass: LTSA/SPD/extrema windowed per file
            return (api.job(m, p).features(*FEATURES).window(per_file=True)
                    .chunk(4).source(api.WavSource(wav_dir)).device(dev))

        # ---- phase 1: run 2 steps, then "crash" ----
        soundscape_job().to(store_dir).limit(2).run()
        print("crashed after 2 committed steps "
              f"(cursor={FeatureStore(store_dir).load_cursor()['cursor']})")

        # ---- phase 2: restart, resume from the committed cursor ----
        resumed = soundscape_job().to(store_dir).run()
        oneshot = soundscape_job().run()
        ok = all(np.array_equal(np.asarray(resumed[f]), oneshot[f])
                 for f in PER_RECORD) and \
            all(np.array_equal(resumed.windows[w], oneshot.windows[w])
                for w in WINDOWED)
        print(f"resume == uninterrupted ({len(PER_RECORD)} per-record "
              f"features + {len(WINDOWED)} windowed products): {ok}")
        print(f"welch {resumed['welch'].shape}, "
              f"percentiles {resumed['percentiles'].shape}, "
              f"mean SPL {np.mean(resumed['spl']):.1f} dB, "
              f"records {resumed.n_records}")
        print(f"per-file LTSA {resumed['ltsa'].shape}, "
              f"SPD {resumed['spd'].shape} "
              f"(window edges {resumed.window_edges['ltsa'].tolist()})")

        # ---- phase 3: stream to a callback sink (live monitoring) ----
        stream_steps = []
        (soundscape_job()
         .to(lambda step, idx, vals: stream_steps.append(len(idx)))
         .run())
        print(f"callback sink streamed {len(stream_steps)} steps, "
              f"{sum(stream_steps)} records")

        # ---- bonus: host loader with straggler speculation ----
        reader = WavRecordReader(wav_dir, m)
        ld = SpeculativeLoader(reader, plan(m, 2, 3), workers=4)
        n = sum(1 for _ in ld)
        print(f"speculative loader streamed {n} steps; stats {ld.stats()}")
        ld.close()
        assert ok


if __name__ == "__main__":
    main()
