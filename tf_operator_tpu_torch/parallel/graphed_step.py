"""Training as CUDA graphs: the counterpart of the JAX trainer's compiled
step (`make_scanned_train_step`'s chunk on synthetic batches,
`make_train_step`'s jitted step on a dataset's, the multi-slice halves), in
one process and on every rank of an NCCL world.

`step_route` is the rule: one process on CUDA, and every rank of a world
whose ranks each have a GPU of their own (NCCL), replays a captured graph
of each optimizer step, or in a multi-slice job of each half of it (the
batch, each microbatch's backward, the apply; parallel/train_step.py's
make_multislice_step_fns), with the DCN exchange on the host between them;
every other run steps eagerly, for the reason it returns. There is no
fallback: a capture or a replay that fails raises.

`GraphedStep` runs one step a call. Its first call runs the step eagerly on
a side stream (the warm-up the PyTorch documentation asks for before a
capture: cuBLAS handles, workspaces and the flash kernels' shared-memory
attributes are set up there, outside the graph, and so is every NCCL
communicator the step's collectives use, point-to-point pairs included,
since ProcessGroupNCCL creates them at their first collective), which is
the step itself, so no step runs twice or is skipped; it then captures the
step, which records the kernels without running them. Every later call
replays the graph. The step reads and writes only tensors that outlive the
call: the model's parameters and buffers, the optimizer state (updated in
place, its count on the device) and the static inputs (`StaticInputs`,
filled by `stage` from pinned host memory, or copied in on the stream).

In a world, the captured NCCL kernels replay on the rank's communicators
in the order they were captured, which is the same on every rank; the
collectives the trainer runs eagerly between replays (the preemption flag,
a checkpoint's gathers) run on the same communicators, ordered on the
stream after the replay. A replay's kernels are invisible to
ProcessGroupNCCL's watchdog, and a lost peer would leave them, and the
host's next read behind them, waiting for ever: `world_watch` enqueues one
empty all-reduce over the world after each replay (it launches nothing) and
then waits, through the trainer's watchdog (parallel/peer_watch.py), for
the replay before the last, so a replay that waits on a lost peer raises
PeerLostError within distributed.TIMEOUT.

The kernel wrappers count launches in Python (ops/*.LAUNCHES), so a capture
would count once kernels that never ran and a replay would count nothing.
`GraphedStep` takes the capture's counts back and adds them again on every
replay: a counter still says how many times the card ran the kernel.

While the tracer is enabled, a step's body stamps its phases on the device
(telemetry/phases.py): the stamps are captured with the step, so every
replay records them. A capture whose warm-up stamped keeps the captured
graph (keep_graph=True), counts each phase's device operations in it
(phases.graph_ops, `phase_ops`) and then instantiates it; any other capture
is made as it is without stamps.
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable

import torch
import torch.distributed as dist

from tf_operator_tpu_torch.parallel import collectives, peer_watch
from tf_operator_tpu_torch.parallel.train_step import TrainState, batch_seed, train_step
from tf_operator_tpu_torch.telemetry import phases

# The variables under which ProcessGroupNCCL waits for a collective on the
# host, which a capture cannot hold (the old name, then the new one).
BLOCKING_WAIT_ENV = ("NCCL_BLOCKING_WAIT", "TORCH_NCCL_BLOCKING_WAIT")


def step_route(device_type: str, world: int, backend: str | None,
               multislice: bool) -> tuple[str, str]:
    """("graph" or "eager", why) for a trainer on `device_type` in a world
    of `world` processes joined over `backend` (in a multi-slice job, the
    slice's world), in a multi-slice job or not."""
    if device_type != "cuda":
        return "eager", "CUDA graphs exist only on a CUDA device"
    if world > 1 and backend != "nccl":
        return "eager", f"{backend}'s collectives run on the host and cannot be captured"
    if multislice:
        where = ("one process" if world == 1 else
                 f"a slice of {world} processes over NCCL (its collectives included)")
        return "graph", (f"a multi-slice job, {where}: the batch, each microbatch's "
                         f"backward and the apply each replay one captured CUDA graph, "
                         f"the DCN exchange on the host between them")
    if world == 1:
        return "graph", "one process on CUDA: each step replays one captured CUDA graph"
    return "graph", (f"a world of {world} processes over NCCL: each rank replays one "
                     f"captured CUDA graph of its step, its collectives included")


def world_watch(device) -> Callable[[], None] | None:
    """In a world of several processes, the call GraphedStep makes after
    each replay (module docstring): an empty all-reduce over the world on
    `device`, then, over NCCL, a watched wait for the replay before the
    last. None in one process. A world whose NCCL waits on the host
    (BLOCKING_WAIT_ENV) is refused: no collective of it could be captured."""
    if not dist.is_initialized() or dist.get_world_size() < 2:
        return None
    nccl = dist.get_backend() == "nccl"
    if nccl:
        for name in BLOCKING_WAIT_ENV:
            if os.environ.get(name, "0") not in ("", "0"):
                raise RuntimeError(f"{name}={os.environ[name]} makes every NCCL collective "
                                   f"wait on the host, which a CUDA graph cannot capture")
    empty = torch.empty(0, device=device)
    # On the card (a CPU test's stand-in world has no stream to wait on).
    pace = nccl and empty.device.type != "cpu"
    behind: list = []

    def watch() -> None:
        with peer_watch.deferred():  # waited for below, one replay behind
            collectives.all_reduce(empty, dist.group.WORLD)
        if pace:
            done = torch.cuda.Event()
            done.record()
            behind.append(done)
            if len(behind) > 1:
                peer_watch.synchronize(behind.pop(0), "the replay before the last")

    return watch


class StaticInputs:
    """One graph's inputs of one dtype: a device buffer and the host buffer
    it is copied from (pinned on CUDA), laid out as `shapes` (name ->
    shape); `views[name]` is the device tensor a body reads."""

    def __init__(self, shapes: dict, device: torch.device, dtype=torch.int64):
        cuda = device.type == "cuda"
        total = sum(math.prod(s) for s in shapes.values())
        # Ordinary tensors even when made under inference mode (a server's
        # load), so that a caller outside it may stage into them too.
        with torch.inference_mode(False):
            self.host_buffer = torch.zeros(total, dtype=dtype, pin_memory=cuda)
            self.device_buffer = torch.zeros(total, dtype=dtype, device=device)
        self.views, self.host_views = {}, {}
        at = 0
        for name, shape in shapes.items():
            n = math.prod(shape)
            self.views[name] = self.device_buffer[at:at + n].view(shape)
            self.host_views[name] = self.host_buffer[at:at + n].numpy().reshape(shape)
            at += n
        # Recorded behind each copy out of the host buffer (an event not yet
        # recorded synchronises at once).
        self.copied = torch.cuda.Event() if cuda else None


def stage(static: StaticInputs, values: dict) -> None:
    """Write `values` (name -> host array of its shape) into the static
    inputs: wait for the previous copy out of the host buffer, fill it,
    then copy it to the device on the current stream."""
    if static.copied is not None:
        static.copied.synchronize()
    for name, a in values.items():
        static.host_views[name][...] = a
    static.device_buffer.copy_(static.host_buffer, non_blocking=True)
    if static.copied is not None:
        static.copied.record()


def launch_counters() -> tuple[dict, ...]:
    """The kernel wrappers' launch counters."""
    from tf_operator_tpu_torch.ops import flash_attention, fused_bottleneck, grouped_matmul

    return (flash_attention.LAUNCHES, fused_bottleneck.LAUNCHES, grouped_matmul.LAUNCHES,
            grouped_matmul.ROUTE_LAUNCHES)


def counts_since(counters, before) -> list[dict]:
    """Each counter's increase over its snapshot in `before`."""
    return [{k: c[k] - b.get(k, 0) for k in c} for c, b in zip(counters, before)]


def add_counts(counters, delta) -> None:
    for c, d in zip(counters, delta):
        for k, n in d.items():
            c[k] += n


_side_stream = None


def _warm_up_stream():
    """The one side stream of every warm-up in this process: cuBLAS keeps a
    workspace for each (handle, stream) it has run on until the process
    ends, so a fresh stream for each trainer run in one process (the
    in-process runs of chip_smoke.py) would leave one behind each time."""
    global _side_stream
    if _side_stream is None:
        _side_stream = torch.cuda.Stream()
    return _side_stream


class GraphedStep:
    """step() runs body() once on the card: eagerly at the first call, then
    captured; a graph replay at every later call. Returns body's metrics
    (the graph's static tensors after a replay: valid until the next
    call). `generators` are the CUDA generators body draws from; the
    default generator is registered by the capture itself. `pool`, a
    torch.cuda.graph_pool_handle(), shares one memory pool among several
    graphs (None: a private pool). `watch` (world_watch's) is called after
    each replay. `phase_ops`: each phase's device operations in the graph,
    where its capture was stamped (else None)."""

    def __init__(self, body: Callable[[], dict], generators=(), counters=None, pool=None,
                 watch: Callable[[], Any] | None = None):
        self.body = body
        self.generators = tuple(generators)
        self.counters = launch_counters() if counters is None else counters
        self.pool = pool
        self.watch = watch
        self.graph = None
        self.metrics: dict = {}
        self.recorded: list[dict] = []
        self.stamped = False
        self.phase_ops: dict | None = None

    def __call__(self) -> dict:
        if self.graph is None:
            stamps = phases.device_stamps()
            before = stamps.launches
            metrics = self._warm_up()
            # The capture follows the warm-up at once: it stamps if that did.
            self.stamped = stamps.launches > before
            self._capture()
            return metrics
        self.graph.replay()
        if self.watch is not None:
            self.watch()
        add_counts(self.counters, self.recorded)
        return self.metrics

    def _warm_up(self) -> dict:
        current = torch.cuda.current_stream()
        side = _warm_up_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = self.body()
        current.wait_stream(side)
        for v in metrics.values():
            v.record_stream(current)
        return metrics

    def _capture(self) -> None:
        before = [dict(c) for c in self.counters]
        walk = self.stamped
        graph = torch.cuda.CUDAGraph(keep_graph=True) if walk else torch.cuda.CUDAGraph()
        stamps = phases.device_stamps()
        if walk:
            stamps.nodes = []
        for gen in self.generators:
            graph.register_generator_state(gen)
        # The flash and grouped-matmul wrappers build their TMA descriptors on
        # the host from the operands' addresses and pass them by value
        # (__grid_constant__), so the graph holds them as they were at the
        # capture. That is sound only because the graph's private pool gives
        # every operand the same address on every replay, and the state and
        # static inputs are never reallocated. Thread-local capture: the
        # input threads of the --data-dir loop may copy to the card meanwhile.
        try:
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                self.metrics = self.body()
        finally:
            captured, stamps.nodes = stamps.nodes, None
        if walk:
            self.phase_ops = stamps.ops = phases.graph_ops(graph.raw_cuda_graph(), captured)
            graph.instantiate()
        self.recorded = counts_since(self.counters, before)
        for c, b in zip(self.counters, before):
            c.update(b)  # the capture ran nothing
        self.graph = graph


def _same_state(state: TrainState, captured: TrainState) -> None:
    if state.model is not captured.model or state.opt_state.count is not captured.opt_state.count:
        raise RuntimeError("the graphed step was captured on another train state")


def _reseed(gen: torch.Generator, seed: int, step: int) -> None:
    gen.manual_seed(batch_seed(seed, step))


def graphed_chunks(loss_fn, tx, make_batch: Callable[[torch.Generator], Any], device,
                   seed: int, plan=None):
    """make_chunked_train_step's run(state, n, every=None) with each step a
    GraphedStep: the batch is made inside the graph from one generator,
    re-seeded on the host before each step with batch_seed(seed, step). A
    fresh generator and a re-seeded one start at the same Philox offset, so
    the batches are batch_generator's."""
    gen = torch.Generator(device=device)
    held: dict = {}

    def run(state: TrainState, n: int, every: list | None = None):
        if not held:
            captured = state

            def body() -> dict:
                phases.start_step(device)
                batch = make_batch(gen)
                if plan is not None:
                    batch = plan.local_rows(batch)
                phases.mark("batch")
                return train_step(captured, batch, loss_fn, tx, plan)[1]

            held.update(state=captured,
                        step=GraphedStep(body, [gen], watch=world_watch(device)))
        _same_state(state, held["state"])
        metrics = None
        for _ in range(n):
            _reseed(gen, seed, state.step)
            metrics = held["step"]()
            state = TrainState(state.step + 1, state.model, state.opt_state)
            if every is not None:
                every.append({k: v.clone() for k, v in metrics.items()})
        return state, {k: v.clone() for k, v in metrics.items()}

    return run


def graphed_batches(loss_fn, tx, preprocess: Callable[[dict], dict], plan=None):
    """The --data-dir loop's step(state, batch) -> (state, metrics) as a
    GraphedStep: each host batch is copied into the graph's static input on
    the current stream, then the graph (preprocess, then the step) replays.
    Every batch must have the first one's shapes and dtypes."""
    static: dict = {}
    held: dict = {}

    def step(state: TrainState, batch: dict):
        if not held:
            static.update({k: v.clone() for k, v in batch.items()})
            captured = state
            device = captured.params[0].device

            def body() -> dict:
                phases.start_step(device)
                batch = preprocess(static)
                phases.mark("batch")
                return train_step(captured, batch, loss_fn, tx, plan)[1]

            held.update(state=captured, step=GraphedStep(body, watch=world_watch(device)))
        else:
            for k, v in batch.items():
                if v.shape != static[k].shape or v.dtype != static[k].dtype:
                    raise ValueError(
                        f"batch {k!r} is {tuple(v.shape)} {v.dtype}; the graphed step was "
                        f"captured at {tuple(static[k].shape)} {static[k].dtype}")
                static[k].copy_(v)
        _same_state(state, held["state"])
        metrics = held["step"]()
        return (TrainState(state.step + 1, state.model, state.opt_state),
                {k: v.clone() for k, v in metrics.items()})

    return step
