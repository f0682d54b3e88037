"""CUDA graphs of the step's plain-PyTorch chains, owned by one job.

A *chain* is a function of a few device tensors that runs PyTorch ops
alone: no hand-written kernel and nothing read back to the host.  A step
has two.  One is the frame statistics that follow the per-frame PSD
(:class:`~repro_torch.api.features.FeatureContext`).  The other is the
carry update (:func:`~repro_torch.api.engine.compile_reduce_update`).
On a CUDA device :class:`StepGraphs` captures each chain once per key
and replays it on every later call with that key.  The key is the
chain's name, the structure its caller names (the segment layout of the
carry update, the statistics of the frame chain), and the shapes and
dtypes of its inputs.  So the chain's tens of launches cost the host
one.  The ``kernels.ops`` calls stay outside every chain: each is still
launched by hand, where a profiler sees it.

A job's first step runs every chain eagerly; it also tells the frame
chain which statistics the job's features read.  After that, the first
call of a key runs the chain eagerly on a side stream (PyTorch's warm-up
before a capture), and that run serves the call; the capture that
follows runs nothing.  Later calls copy their inputs into the graph's
static inputs and replay.  An input that *is* a static output of
another of the job's graphs is read in place and not copied: the carry
reads the frame chain's dB spectrogram so.  A replay runs the same
kernels on the same data as the eager chain, so it gives the same bits.

A graph's outputs are its own static buffers, valid until its next
replay: the caller clones what must live longer.  Each graph with
outputs has a memory pool of its own, so no other graph's temporaries
alias them.  The graphs without outputs (the carry updates, which
write the carry in place) share one pool: they never run at once and
leave nothing behind in it.

On the CPU every chain runs eagerly: one code path serves both devices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple           # static inputs (an adopted one is the producer's)
    outputs: tuple          # static outputs
    adopted: tuple          # per input: the static output read in place


class StepGraphs:
    """One executor's chains of one job: captured graphs on a CUDA
    device, eager calls elsewhere.

    ``counts`` holds the chain runs so far: ``replays`` (served by a
    replay), ``captures`` (served by the warm-up of a capture) and
    ``eager`` (run without a graph: on the CPU, and in the job's first
    step).  ``uses`` maps a chain to the names its callers asked of it,
    in the order first asked (the frame statistics).  ``device`` None
    gives a runner that never captures, for a context outside a job.
    """

    def __init__(self, device: torch.device | None = None):
        self.capture = device is not None \
            and torch.device(device).type == "cuda"
        self.device = None if device is None else torch.device(device)
        self.first_step = True
        self.counts = dict.fromkeys(("replays", "captures", "eager"), 0)
        self.uses: dict[str, list] = {}
        self._graphs: dict[tuple, _Graph] = {}
        self._outputs: dict[int, torch.Tensor] = {}  # data_ptr -> output
        self._stream = None
        self._pool = None       # shared by the graphs without outputs

    def owns(self, t: torch.Tensor) -> bool:
        """Whether ``t`` views a graph's static output (a later replay
        rewrites it)."""
        return bool(self._outputs) and any(
            t.untyped_storage().data_ptr()
            == o.untyped_storage().data_ptr()
            for o in self._outputs.values())

    def _adopt(self, t: torch.Tensor):
        """The static output ``t`` is, whole, or None."""
        o = self._outputs.get(t.data_ptr())
        return o if o is not None and t.is_contiguous() \
            and t.numel() == o.numel() else None

    def run(self, name: str, fn: Callable, inputs: tuple,
            structure=()) -> tuple:
        """``fn(*inputs)``, a tuple of tensors: eagerly, or through the
        graph of this key (captured on its first call)."""
        if not self.capture or self.first_step:
            self.counts["eager"] += 1
            return tuple(fn(*inputs))
        key = (name, structure,
               tuple((tuple(t.shape), t.dtype) for t in inputs))
        adopted = tuple(self._adopt(t) for t in inputs)
        g = self._graphs.get(key)
        if g is None or any(a is not b for a, b in zip(adopted, g.adopted)):
            self.counts["captures"] += 1
            return self._capture(key, fn, inputs, adopted)
        self.counts["replays"] += 1
        for s, t, a in zip(g.inputs, inputs, g.adopted):
            if a is None:
                s.copy_(t)
        g.graph.replay()
        return g.outputs

    def _capture(self, key, fn, inputs, adopted) -> tuple:
        old = self._graphs.pop(key, None)
        if old is not None:
            for o in old.outputs:
                self._outputs.pop(o.data_ptr(), None)
        cur = torch.cuda.current_stream(self.device)
        static = tuple(t if a is not None else t.clone()
                       for t, a in zip(inputs, adopted))
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side = self._stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = tuple(fn(*static))           # serves this call
        cur.wait_stream(side)
        for w in warm:
            w.record_stream(cur)
        if warm:
            pool = torch.cuda.graph_pool_handle()
        else:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            pool = self._pool
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                outputs = tuple(fn(*static))
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        for o, w in zip(outputs, warm):
            o.copy_(w)
            self._outputs[o.data_ptr()] = o
        self._graphs[key] = _Graph(graph, static, outputs, adopted)
        return outputs
