"""``python -m repro_torch.launch.depam_run`` on the CPU (``--device
cpu``), over a tiny wav corpus for both paper parameter sets: the
stored arrays equal the port's library job bitwise and the reference
CLI's within tolerance, ``summary.json`` has the reference's keys,
``--sync-io`` writes the same bytes as the pipelined default, a second
run resumes, ``--shards``/``--data-parallel`` store the library's
sharded bits, and ``--to zarr|netcdf`` and ``--instrument`` write the
library job's bits into labeled outputs."""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import PARAM_SET_1, PARAM_SET_2
from repro_torch.core.store import FeatureStore
from repro_torch.data.wavio import write_dataset
from repro_torch.launch import depam_run

ROOT = Path(__file__).resolve().parents[1]
SETS = {1: (PARAM_SET_1, 0.05), 2: (PARAM_SET_2, 0.25)}
FILES, PER_FILE, CHUNK, WINDOW = 2, 3, 4, 2
FEATURES = ("welch", "spl", "tol", "percentiles", "ltsa", "spd")
DENSE = ("welch", "spl", "tol", "percentiles")
WINDOWED = ("ltsa", "spd")
# frame SPL: noise about -50 dB, bursts -30 to -42 dB
THRESHOLD_DB, HYSTERESIS_DB = -46.0, 1.5
# (linear rel, dB abs) as tests/test_torch_job.py: set 1, Cooley-Tukey
TOL = {1: (1e-4, 1e-3), 2: (1e-3, 5e-3)}
LINEAR = ("welch", "ltsa")


def _params(set_id):
    base, sec = SETS[set_id]
    return dataclasses.replace(base, record_size_sec=sec)


def _gen(p):
    """Quiet noise plus a Hann-windowed 1 kHz burst in two of every
    three records, far from the threshold and the close level.  The
    bursts stay 20-30 dB over the noise: two float32 FFT algorithms
    agree to ~1e-3 of a frame's largest bins, so under a burst 40 dB up
    the noise bins' levels would agree only to a few hundredths of a
    dB."""
    def gen(fi, n):
        rng = np.random.default_rng([7, fi])
        x = rng.standard_normal(n) * 0.003
        rs = p.record_size
        for r in range(n // rs):
            if (r + fi) % 3 == 2:
                continue
            pos = r * rs + (rs // 3 if r % 2 else rs // 8)
            length = min(600, rs // 4)
            x[pos:pos + length] += 0.05 * np.hanning(length) * np.sin(
                2 * np.pi * 1000.0 * np.arange(length) / p.fs)
        return x
    return gen


def _manifest(p):
    return DatasetManifest(n_files=FILES, records_per_file=PER_FILE,
                           record_size=p.record_size, fs=p.fs, seed=42)


def _cli(module, set_id, wavs, out, *extra):
    args = [sys.executable, "-m", module, "--param-set", str(set_id),
            "--files", str(FILES), "--records-per-file", str(PER_FILE),
            "--record-sec", str(SETS[set_id][1]),
            "--chunk-records", str(CHUNK), "--wav-dir", wavs, "--out", out,
            "--features", ",".join(FEATURES), "--window", str(WINDOW),
            "--events", f"--event-threshold-db={THRESHOLD_DB}",
            f"--event-hysteresis-db={HYSTERESIS_DB}", *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(args, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _stored(out):
    """Everything a run leaves in its store: per-record and windowed
    arrays, and the event logs."""
    arrays = {k: np.load(f"{out}/{k}.npy") for k in DENSE + WINDOWED}
    store = FeatureStore(out)
    for name, cols in (("events", api.EVENT_COLUMNS),
                       ("impulsive", api.IMPULSIVE_COLUMNS)):
        arrays[name] = store.load_events(name, len(cols))
    return arrays


@pytest.fixture(scope="module", params=sorted(SETS), ids=lambda s: f"set{s}")
def runs(request, tmp_path_factory):
    """Per set: the corpus, then the port's CLI pipelined (twice: the
    second run resumes), with --sync-io, and the reference CLI."""
    set_id = request.param
    p = _params(set_id)
    tmp = tmp_path_factory.mktemp(f"cli{set_id}")
    wavs = str(tmp / "wavs")
    write_dataset(wavs, _manifest(p), gen=_gen(p))
    port = "repro_torch.launch.depam_run"
    out = {"set": set_id, "p": p, "wavs": wavs,
           "async": str(tmp / "async"), "sync": str(tmp / "sync"),
           "ref": str(tmp / "ref")}
    out["log"] = _cli(port, set_id, wavs, out["async"], "--device", "cpu")
    out["arrays"] = _stored(out["async"])
    out["rerun_log"] = _cli(port, set_id, wavs, out["async"],
                            "--device", "cpu")
    _cli(port, set_id, wavs, out["sync"], "--device", "cpu", "--sync-io")
    _cli("repro.launch.depam_run", set_id, wavs, out["ref"])
    return out


def test_cli_equals_library_job_bitwise(runs):
    p = runs["p"]
    res = (api.job(_manifest(p), p).features(*FEATURES).chunk(CHUNK)
           .window(records=WINDOW).source(api.WavSource(runs["wavs"]))
           .events(THRESHOLD_DB, hysteresis_db=HYSTERESIS_DB,
                   impulsive=True)
           .device("cpu").run())
    got = runs["arrays"]
    for k in DENSE + WINDOWED:
        assert np.array_equal(got[k], res[k], equal_nan=True), k
    for k in ("events", "impulsive"):
        counts, rows = got[k]
        assert np.array_equal(counts, res.events[k].counts), k
        assert np.array_equal(rows, res.events[k].rows), k
    assert res.events["events"].n_events > 0


def test_sync_io_writes_the_same_bytes(runs):
    sync = _stored(runs["sync"])
    for k, v in runs["arrays"].items():
        for a, b in zip(v, sync[k]) if isinstance(v, tuple) \
                else [(v, sync[k])]:
            assert np.array_equal(a, b, equal_nan=True), k
    summary = json.loads(Path(runs["sync"], "summary.json").read_text())
    assert summary["executor"] == "sync"


def test_cli_matches_reference_cli(runs):
    """Dense and LTSA arrays within the job tolerances, event logs with
    the same counts and integer columns.  spd is left out: one frame
    whose last bits land on the other side of a 3 dB bin edge moves a
    whole frame's density."""
    rel, db = TOL[runs["set"]]
    tol = {k: rel if k in LINEAR else db for k in DENSE + ("ltsa",)}
    tol["percentiles"] = 5e-3       # as tests/test_torch_events.py
    got, want = runs["arrays"], _stored(runs["ref"])
    for k, t in tol.items():
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        assert g.shape == w.shape, k
        err = np.abs(g - w) / np.abs(w) if k in LINEAR else np.abs(g - w)
        assert np.max(err) < t, k
    assert np.array_equal(got["spd"].sum(axis=-1) > 0,
                          want["spd"].sum(axis=-1) > 0)
    for k in ("events", "impulsive"):
        assert np.array_equal(got[k][0], want[k][0]), k
    assert np.array_equal(got["events"][1][:, :3], want["events"][1][:, :3])
    assert np.max(np.abs(got["events"][1][:, 3]
                         - want["events"][1][:, 3])) < db


def test_summary_has_the_reference_fields(runs):
    got = json.loads(Path(runs["async"], "summary.json").read_text())
    want = json.loads(Path(runs["ref"], "summary.json").read_text())
    assert sorted(got) == sorted(want)
    assert got["records"] == want["records"] == FILES * PER_FILE
    assert got["executor"] == want["executor"] \
        == "pipelined (prefetch depth 2)"
    assert got["windows"] == want["windows"]
    assert got["events"] == want["events"]
    assert got["events"]["events"]["n_events"] > 0


def test_second_run_resumes_and_changes_nothing(runs):
    n_steps = -(-FILES * PER_FILE // CHUNK)
    assert "resuming" not in runs["log"]
    assert f"[depam] resuming at step {n_steps}" in runs["rerun_log"]
    assert "job was already complete" in runs["rerun_log"]
    again = _stored(runs["async"])
    for k, v in runs["arrays"].items():
        for a, b in zip(v, again[k]) if isinstance(v, tuple) \
                else [(v, again[k])]:
            assert np.array_equal(a, b, equal_nan=True), k


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Set 1 through the CLI with ``--shards 4 --data-parallel 2`` on
    two CPU executors, one record a step; then the same command again."""
    p = _params(1)
    tmp = tmp_path_factory.mktemp("sharded")
    wavs = str(tmp / "wavs")
    write_dataset(wavs, _manifest(p), gen=_gen(p))
    out = str(tmp / "out")
    args = ["--param-set", "1", "--files", str(FILES),
            "--records-per-file", str(PER_FILE), "--record-sec",
            str(SETS[1][1]), "--chunk-records", "1", "--wav-dir", wavs,
            "--out", out, "--features", ",".join(FEATURES), "--window",
            str(WINDOW), "--events", f"--event-threshold-db={THRESHOLD_DB}",
            f"--event-hysteresis-db={HYSTERESIS_DB}", "--device", "cpu",
            "--shards", "4", "--data-parallel", "2"]
    logs = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            depam_run.main(args)
        logs.append(buf.getvalue())
    return {"p": p, "wavs": wavs, "out": out, "logs": logs,
            "arrays": _stored(out)}


def test_sharded_cli_equals_library_job_bitwise(sharded):
    """``--shards 4 --data-parallel 2`` stores the same bits as the
    library's ``.shards(4)`` job with no mesh, and prints the mesh and
    partition lines."""
    p = sharded["p"]
    res = (api.job(_manifest(p), p).features(*FEATURES).chunk(1)
           .shards(4).window(records=WINDOW)
           .source(api.WavSource(sharded["wavs"]))
           .events(THRESHOLD_DB, hysteresis_db=HYSTERESIS_DB,
                   impulsive=True).device("cpu").run())
    got = sharded["arrays"]
    for k in DENSE + WINDOWED:
        assert np.array_equal(got[k], res[k], equal_nan=True), k
    for k in ("events", "impulsive"):
        counts, rows = got[k]
        assert np.array_equal(counts, res.events[k].counts), k
        # the store's log is append-ordered; the library result is in
        # record order, and the counts give the permutation
        assert np.array_equal(
            api.sinks.reorder_event_rows(counts, rows,
                                         res.events[k].capacity,
                                         res.plan.record_order()),
            res.events[k].rows), k
    log = sharded["logs"][0]
    assert "[depam] mesh: data=2 (of 2 mesh devices)" in log
    assert "[depam] partition: 4 worker slices, balance ratio" in log
    summary = json.loads(Path(sharded["out"], "summary.json").read_text())
    assert summary["records"] == FILES * PER_FILE


def test_sharded_cli_rerun_resumes_and_changes_nothing(sharded):
    log = sharded["logs"][1]
    assert "[depam] resuming at step" in log
    assert "job was already complete" in log
    again = _stored(sharded["out"])
    for k, v in sharded["arrays"].items():
        for a, b in zip(v, again[k]) if isinstance(v, tuple) \
                else [(v, again[k])]:
            assert np.array_equal(a, b, equal_nan=True), k


def test_data_parallel_beyond_the_visible_cards_exits_naming_the_count(
        tmp_path, capsys):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(SystemExit) as exc:
        depam_run.main(["--out", str(tmp_path / "o"), "--shards",
                        str(n + 1), "--data-parallel", str(n + 1)])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert f"--data-parallel {n + 1}" in err
    assert f"only {n} CUDA device(s) visible" in err
    assert not (tmp_path / "o").exists()


def test_shards_not_divisible_by_data_parallel_exits(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        depam_run.main(["--out", str(tmp_path / "o"), "--device", "cpu",
                        "--shards", "3", "--data-parallel", "2"])
    assert exc.value.code != 0
    assert "not divisible" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


@pytest.fixture(scope="module")
def set1_wavs(tmp_path_factory):
    p = _params(1)
    wavs = str(tmp_path_factory.mktemp("labeled") / "wavs")
    write_dataset(wavs, _manifest(p), gen=_gen(p))
    return wavs


def _labeled(out, fmt):
    """Dense and windowed arrays, and the event logs as (counts, rows),
    read back from a run's Zarr group or NetCDF file."""
    cols = {"events": api.EVENT_COLUMNS, "impulsive": api.IMPULSIVE_COLUMNS}
    if fmt == "zarr":
        def read(name):
            return api.read_zarr_array(f"{out}/features.zarr/{name}")
    else:
        from scipy.io import netcdf_file
        with netcdf_file(f"{out}/features.nc", "r", mmap=False) as nc:
            data = {k: np.array(v[:]) for k, v in nc.variables.items()}
            attrs = dict(nc._attributes)

        def read(name):
            return data[name]
    got = {k: read(k) for k in DENSE + WINDOWED}
    for name, c in cols.items():
        got[name] = (read(f"{name}_counts"),
                     np.stack([read(f"{name}_{col}") for col in c], axis=1))
    if fmt == "zarr":
        with open(f"{out}/features.zarr/.zattrs") as f:
            attrs = json.load(f)
    return got, attrs


@pytest.mark.parametrize("flags", [
    ["--to", "zarr"], ["--to", "netcdf"], ["--instrument=-170:12:2"],
    ["--to", "zarr", "--instrument=-170:12:2"]],
    ids=["zarr", "netcdf", "instrument", "zarr-instrument"])
def test_labeled_output_flags_equal_library_job(flags, set1_wavs,
                                                tmp_path, capsys):
    """``--to zarr|netcdf`` and ``--instrument`` run on the CPU: the
    labeled outputs (or, for a store, its arrays) hold the library job's
    bits, the instrument lands in summary.json and the output attrs."""
    p, out = _params(1), str(tmp_path / "o")
    depam_run.main([
        "--device", "cpu", "--param-set", "1", "--files", str(FILES),
        "--records-per-file", str(PER_FILE), "--record-sec",
        str(SETS[1][1]), "--chunk-records", str(CHUNK), "--wav-dir",
        set1_wavs, "--out", out, "--features", ",".join(FEATURES),
        "--window", str(WINDOW), "--events",
        f"--event-threshold-db={THRESHOLD_DB}",
        f"--event-hysteresis-db={HYSTERESIS_DB}", *flags])
    log = capsys.readouterr().out
    inst = api.Instrument(-170.0, gain_db=12.0, vpp=2.0) \
        if "--instrument=-170:12:2" in flags else None
    res = (api.job(_manifest(p), p).features(*FEATURES).chunk(CHUNK)
           .window(records=WINDOW).source(api.WavSource(set1_wavs))
           .events(THRESHOLD_DB, hysteresis_db=HYSTERESIS_DB,
                   impulsive=True).instrument(inst).device("cpu").run())
    fmt = flags[1] if flags[0] == "--to" else "store"
    with open(f"{out}/summary.json") as f:
        summary = json.load(f)
    assert summary["output"]["format"] == fmt
    if fmt == "store":
        got, attrs = _stored(out), {}
    else:
        got, attrs = _labeled(out, fmt)
        assert f"[depam] output: {fmt} at " in log
    for k in DENSE + WINDOWED:
        assert np.array_equal(got[k], res[k], equal_nan=True), k
    for k in ("events", "impulsive"):
        counts, rows = got[k]
        assert np.array_equal(counts, res.events[k].counts), k
        assert np.array_equal(rows, res.events[k].rows), k
    assert res.events["events"].n_events > 0
    if inst is not None:
        assert summary["instrument"] == inst.to_state()
        assert "[depam] instrument: sensitivity -170 dB" in log
        if fmt == "zarr":
            assert attrs["instrument_sensitivity_db_re_1V_per_uPa"] == -170


def test_default_device_without_cuda_exits_loudly(tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        depam_run.main(["--out", str(tmp_path / "o")])
    assert exc.value.code != 0
    assert "--device cuda: no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
