"""Stand-ins for torch.cuda's stream and graph calls, so that the port's
graphed step (parallel/graphed_step.py) runs on the CPU: a "capture" runs
the step's body and puts back the state it wrote (a real capture records
the kernels without running them), and a "replay" runs the body again,
writing its results into the step's static metrics, and, like a graph,
bumps no Python launch counter. What a replay computes on the card is held
by chip_smoke's graph checks, not here.

`install(setattr, fake)` patches torch.cuda and GraphedStep through
`setattr` (pytest's monkeypatch.setattr, or `patched()`'s outside pytest).
With `fake.forbid_host_reads`, every Tensor method that reads a tensor on
the host (HOST_READS) raises inside a capture and a replay: the body of a
graph may not wait for the device. The one exception is a read made by a
kernel's plain version where its kernel reads nothing (PLAIN_READS): on a
CPU tensor the grouped matmul's plain version walks the groups on the
host, its CUDA kernels find their groups on the card.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from tf_operator_tpu_torch.parallel import graphed_step

HOST_READS = ("item", "tolist", "__bool__", "__float__", "__int__", "cpu", "numpy")
# (file, function) of the plain versions' host reads.
PLAIN_READS = {("grouped_matmul.py", "_group_rows")}


class HostReadInCapture(RuntimeError):
    """A tensor was read on the host inside a captured step."""


class FakeStream:
    def wait_stream(self, other):
        pass


class FakeGraph:
    """A stand-in for torch.cuda.CUDAGraph: a replay runs the captured
    step's body again, writes its results into the step's static metrics
    and, like a graph, bumps no Python counter."""

    def __init__(self):
        self.generators, self.replays, self.step, self.fake = [], 0, None, None

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1
        before = [dict(c) for c in self.step.counters]
        with self.fake.no_host_reads() if self.fake else contextlib.nullcontext():
            out = self.step.body()
        for c, b in zip(self.step.counters, before):
            c.update(b)
        for k, v in out.items():
            self.step.metrics[k].copy_(v)


class FakeCuda:
    """The graphs made, and the tensors a stand-in capture restores: a real
    capture records the step without running it, this one runs it."""

    def __init__(self, forbid_host_reads: bool = False):
        self.graphs, self.kept = [], []
        self.forbid_host_reads = forbid_host_reads

    def keep(self, state):
        o = state.opt_state
        self.kept.extend([*state.params, *state.model.buffers(), o.count, *o.mu, *o.nu,
                          *o.master])

    @contextlib.contextmanager
    def no_host_reads(self):
        """HOST_READS raise for the duration, with forbid_host_reads."""
        if not self.forbid_host_reads:
            yield
            return
        real = {name: getattr(torch.Tensor, name) for name in HOST_READS}

        def refuse(name):
            def read(self, *args, **kwargs):
                code = sys._getframe(1).f_code
                if (os.path.basename(code.co_filename), code.co_name) in PLAIN_READS:
                    return real[name](self, *args, **kwargs)
                raise HostReadInCapture(f"Tensor.{name} of a {tuple(self.shape)} tensor "
                                        f"inside a captured step")
            return read

        for name in HOST_READS:
            setattr(torch.Tensor, name, refuse(name))
        try:
            yield
        finally:
            for name, fn in real.items():
                setattr(torch.Tensor, name, fn)


def install(setattr_, fake: FakeCuda) -> FakeCuda:
    """Replace torch.cuda's graph and stream calls and GraphedStep's
    capture hook through setattr_(obj, name, value)."""

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode=None):
        fake.graphs.append(g)
        saved = [t.detach().clone() for t in fake.kept]
        # A real capture draws nothing from its registered generators either.
        states = [gen.get_state() for gen in g.generators]
        with fake.no_host_reads():
            yield
        with torch.no_grad():
            for t, v in zip(fake.kept, saved):
                t.copy_(v)
        for gen, state in zip(g.generators, states):
            gen.set_state(state)

    real_capture = graphed_step.GraphedStep._capture

    def capture(self):
        real_capture(self)
        self.graph.step, self.graph.fake = self, fake

    setattr_(torch.cuda, "CUDAGraph", FakeGraph)
    setattr_(torch.cuda, "graph", graph)
    setattr_(torch.cuda, "graph_pool_handle", lambda: object())
    setattr_(torch.cuda, "Stream", FakeStream)
    setattr_(torch.cuda, "current_stream", lambda *a: FakeStream())
    setattr_(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    setattr_(torch.Tensor, "record_stream", lambda self, s: None)
    setattr_(graphed_step.GraphedStep, "_capture", capture)
    return fake


@contextlib.contextmanager
def patched():
    """A setattr for install() outside pytest: every attribute it sets is
    put back on exit."""
    saved = []

    def setattr_(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    try:
        yield setattr_
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
