"""Seeded inputs: the live record pool.

Everything is drawn from the run's ``--seed`` on the run's device with a
``torch.Generator``, in a few large calls, and only then moved to the
host as 16-bit PCM.  The pattern is the smoke test's corpus: white noise
of 3000 counts and a tone of 1000 counts at 50-450 Hz per record.
"""
from __future__ import annotations

import numpy as np
import torch

NOISE_COUNTS = 3000.0
TONE_COUNTS = 1000.0


def generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one use of the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def pcm_records(seed: int, stream: int, n_records: int, record_size: int,
                fs: float, device: torch.device) -> np.ndarray:
    """(n_records, record_size) int16 PCM: noise plus one tone a record."""
    g = generator(seed, device, stream)
    x = torch.randn((n_records, record_size), generator=g, device=device,
                    dtype=torch.float32) * NOISE_COUNTS
    freq = 50.0 + 400.0 * torch.rand((n_records, 1), generator=g,
                                     device=device, dtype=torch.float64)
    t = torch.arange(record_size, device=device, dtype=torch.float64) / fs
    x += (TONE_COUNTS * torch.sin(2 * torch.pi * freq * t)).to(torch.float32)
    return torch.clamp(torch.round(x), -32768, 32767).to(
        torch.int16).cpu().numpy()


def live_pool(cfg: dict, seed: int, n: int, device: torch.device
              ) -> tuple[np.ndarray, np.ndarray]:
    """The live stream's pool: ``n`` int16 records and a float32 decode
    scale each (full scale times a gain of 8-12, as a calibrated
    channel ships it)."""
    fs = float(cfg["fs"])
    rs = int(round(cfg["record_size_sec"] * fs))
    pcm = pcm_records(seed, 1 << 20, n, rs, fs, device)
    gains = 8.0 + 4.0 * np.random.default_rng([int(seed), 2]).random(n)
    scale = np.float32(1.0) / np.float32(32767.0)
    return pcm, (scale * gains.astype(np.float32)).astype(np.float32)
