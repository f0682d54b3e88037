"""The port's windowed reductions (ltsa, spd, min/max) against numpy
oracles over the cases of the reference's windowed-reduction property
test: manifest layouts with empty files, windows of 1, 3 and 7 records,
per file and per epoch, chunks of 1, 2 and 5 (padding masks), and a
resume after 2 steps — under both executors.

Empty per-file windows hold NaN, so the resume check compares with
``equal_nan=True``.
"""
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api.sources import synth_record
from repro_torch.core import spectra
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams

P = DepamParams(nfft=256, window_size=256, window_overlap=128,
                record_size_sec=0.25)
FILE_COUNTS = [(1,), (0, 3), (2, 0, 3), (5, 5, 0, 1), (3, 4)]
WINDOWS = [1, 3, 7, "file", "epoch"]
CHUNKS = [1, 2, 5]
RESUME_STEPS = 2
WINDOWED = ("ltsa", "spd", "min_welch", "max_welch")


def frame_db_oracle(m):
    """(n_records, n_frames, n_bins) dB spectrogram of the port's
    synthesized records, by the plain ``core.spectra`` chain."""
    recs = torch.stack([synth_record(i, m, "cpu")
                        for i in range(m.n_records)])
    fp = spectra.frame_psd(recs, P).numpy().astype(np.float64)
    return 10.0 * np.log10(np.maximum(fp, 1e-30)) + P.gain_db


def spd_oracle(db, edges):
    """np.histogram(density=True) per (window, freq bin) — pypam
    compute_spd semantics."""
    bins = np.arange(api.SPD_DB_MIN,
                     api.SPD_DB_MAX + api.SPD_DB_STEP / 2, api.SPD_DB_STEP)
    out = np.zeros((len(edges) - 1, db.shape[-1], api.SPD_N_DB))
    for w, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        for b in range(db.shape[-1]):
            vals = db[lo:hi, :, b].ravel()
            if len(vals) and ((vals >= bins[0]) & (vals < bins[-1])).any():
                out[w, b] = np.histogram(vals, bins=bins, density=True)[0]
    return out


@pytest.mark.parametrize("executor", ["sync", "async"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("wsel", WINDOWS)
@pytest.mark.parametrize("file_counts", FILE_COUNTS,
                         ids=lambda fc: "files" + "-".join(map(str, fc)))
def test_windowed_reductions_match_numpy(file_counts, wsel, chunk,
                                         executor):
    m = DatasetManifest.from_files(file_counts, record_size=P.record_size,
                                   fs=P.fs, seed=23)

    def build(sink=None, limit=None):
        j = (api.job(m, P).features("welch", "ltsa", "spd", "minmax")
             .chunk(chunk).kernels(False).to(sink).limit(limit)
             .device("cpu"))
        j = j.async_io() if executor == "async" else j.sync_io()
        if wsel == "file":
            return j.window(per_file=True)
        if wsel == "epoch":
            return j.window()
        return j.window(records=wsel)

    res = build().run()
    edges = res.window_edges["ltsa"]
    assert edges[-1] == m.n_records

    # ---- oracles from the same run's per-record welch ----
    w64 = res["welch"].astype(np.float64)
    for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        if hi == lo:          # empty per-file window -> NaN
            assert np.isnan(res["ltsa"][i]).all()
            assert np.isnan(res["min_welch"][i]).all()
            continue
        assert np.allclose(res["ltsa"][i], w64[lo:hi].mean(0),
                           rtol=1e-6), i
        assert np.array_equal(res["min_welch"][i],
                              res["welch"][lo:hi].min(0)), i
        assert np.array_equal(res["max_welch"][i],
                              res["welch"][lo:hi].max(0)), i
    assert np.allclose(res["spd"], spd_oracle(frame_db_oracle(m), edges),
                       atol=1e-7)

    # ---- mid-window resume is bitwise-identical ----
    limit = min(RESUME_STEPS, max(res.plan.n_steps - 1, 0))
    if limit > 0:
        with tempfile.TemporaryDirectory() as d:
            build(sink=d, limit=limit).run()
            resumed = build(sink=d).run()
            for name in WINDOWED:
                assert np.array_equal(resumed.windows[name],
                                      res.windows[name],
                                      equal_nan=True), name
            assert np.array_equal(np.asarray(resumed["welch"]),
                                  res["welch"])
            assert np.array_equal(resumed["mean_welch"],
                                  res["mean_welch"])
