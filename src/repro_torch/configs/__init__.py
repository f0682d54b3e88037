"""Architecture registry.

``get(name)`` returns the exact assigned ModelConfig;
``get(name, reduced=True)`` returns the CPU-smoke-test reduction of the
same family (same code paths, tiny dims).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "minicpm3-4b", "internlm2-20b", "starcoder2-7b", "qwen1.5-0.5b",
    "arctic-480b", "qwen3-moe-30b-a3b", "internvl2-1b", "zamba2-1.2b",
    "mamba2-2.7b", "seamless-m4t-large-v2",
]


def _module(name: str):
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str, reduced: bool = False):
    m = _module(name)
    return m.REDUCED if reduced else m.CONFIG
