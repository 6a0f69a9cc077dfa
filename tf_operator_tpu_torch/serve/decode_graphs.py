"""The serving decode as CUDA graphs: the counterpart of the JAX server's
`jax.jit` of prefill_into_slots over its (rows x seq-len) bucket grid and of
its decode tick, each with the KV cache donated
(tf_operator_tpu/serve/server.py:603-630).

`serve_route` is the rule: a server of a generative model on CUDA replays
captured graphs; every other server runs eagerly, for the reason it
returns. There is no flag and no fallback: a capture or a replay that fails
raises.

`GraphedDecode` holds one graph of the decode tick at its one shape (every
cache slot, the whole window) and one graph of prefill_into_slots at each
grid point, each a parallel.graphed_step.GraphedStep over models/decode.py's
device bodies: a point's first call is its warm-up (eager, on the warm-up
stream) and its capture, and every later call a replay. The server makes
those first calls at load, over the grid it warms, then `seal`s: a call at
a shape that was not captured raises. Each callable keeps the eager
function's signature, `(params, k, v, tokens, ...) -> (k, v, next,
logits)`, and its host checks (decode.check_slot_ids, check_positions),
which run before anything is copied.

What a graph reads and writes outlives it: the captured parameter dict (a
checkpoint swap copies the new weights into these tensors in place,
`adopt`), the one KV cache pair (updated in place, as JAX's donation makes
it), the score scale, and each graph's static inputs. A graph's static
inputs are one int64 device buffer (tokens, then lengths and slot ids, or
positions), written only by one copy from a pinned host buffer of the same
layout, on the current stream and so after every replay queued before it.
Before the host rewrites a pinned buffer it waits for the event recorded
behind that buffer's last copy: a copy still queued never reads the next
call's values.

Memory: the prefill graphs share one pool. They replay in any order, so a
prefill's replay may overwrite another prefill's outputs; the tick has a
pool of its own. A call's outputs (next tokens, logits) are valid until the
next call of this object, and the server reads them at once (the next
tokens to the host) or drops them.
"""

from __future__ import annotations

import numpy as np
import torch

from tf_operator_tpu_torch.models import decode
from tf_operator_tpu_torch.parallel.graphed_step import GraphedStep


def serve_route(device_type: str, generative: bool) -> tuple[str, str]:
    """("graph" or "eager", why) for a server on `device_type` serving a
    generative model or a classifier."""
    if device_type != "cuda":
        return "eager", "CUDA graphs exist only on a CUDA device"
    if not generative:
        return "eager", ("the classifier's bucketed forward is not captured: it runs "
                         "eagerly at each bucket")
    return "graph", ("a generative model on CUDA: each decode tick and each prefill grid "
                     "point replays one captured CUDA graph")


class StaticInputs:
    """One graph's int64 inputs: a device buffer and the host buffer it is
    copied from (pinned on CUDA), laid out as `shapes` (name -> shape);
    `views[name]` is the device tensor a body reads."""

    def __init__(self, shapes: dict, device: torch.device):
        cuda = device.type == "cuda"
        total = sum(int(np.prod(s)) for s in shapes.values())
        self.host_buffer = torch.zeros(total, dtype=torch.int64, pin_memory=cuda)
        self.device_buffer = torch.zeros(total, dtype=torch.int64, device=device)
        self.views, self.host_views = {}, {}
        at = 0
        for name, shape in shapes.items():
            n = int(np.prod(shape))
            self.views[name] = self.device_buffer[at:at + n].view(shape)
            self.host_views[name] = self.host_buffer[at:at + n].numpy().reshape(shape)
            at += n
        # Recorded behind each copy out of the host buffer (an event not yet
        # recorded synchronises at once).
        self.copied = torch.cuda.Event() if cuda else None


def stage(static: StaticInputs, values: dict) -> None:
    """Write `values` (name -> host int64 array of its shape) into the
    static inputs: wait for the previous copy out of the host buffer, fill
    it, then copy it to the device on the current stream."""
    if static.copied is not None:
        static.copied.synchronize()
    for name, a in values.items():
        static.host_views[name][...] = a
    static.device_buffer.copy_(static.host_buffer, non_blocking=True)
    if static.copied is not None:
        static.copied.record()


class GraphedDecode:
    """prefill(...) and decode(...), the server's _prefill_fn and _decode_fn
    on the graph route, over `params` (the dict every graph reads) and the
    cache pair `kv`."""

    def __init__(self, params: dict, kv: tuple, cfg):
        self.params = params
        self.k, self.v = kv
        self.cfg = cfg
        self.device = self.k.device
        self.scale = decode.score_scale(cfg, self.device)
        self.prefill_pool = torch.cuda.graph_pool_handle()
        self.prefills: dict[tuple[int, int], tuple[StaticInputs, GraphedStep]] = {}
        self.tick: tuple[StaticInputs, GraphedStep] | None = None
        self.sealed = False

    def seal(self) -> None:
        """No more captures: a call at a shape not captured raises."""
        self.sealed = True

    def _same(self, params, k, v) -> None:
        if params is not self.params or k is not self.k or v is not self.v:
            raise RuntimeError("the decode graphs were captured on another parameter dict "
                               "or KV cache")

    def _capturable(self, what: str) -> None:
        if self.sealed:
            raise ValueError(f"{what} is outside the captured grid: prefill "
                             f"{sorted(self.prefills)} (rows, tokens), the tick at "
                             f"{self.k.shape[1]} slots")

    def prefill(self, params, k, v, tokens, lengths, slot_ids):
        """decode.prefill_into_slots at a captured (rows, tokens) point."""
        self._same(params, k, v)
        ids = decode.check_slot_ids(slot_ids, self.k.shape[1])
        tokens = decode.host_index(tokens, "tokens")
        lengths = decode.host_index(lengths, "lengths")
        key = tokens.shape
        if len(key) != 2 or lengths.shape != key[:1] or ids.shape != key[:1]:
            raise ValueError(f"prefill tokens {key}, lengths {lengths.shape} and slot ids "
                             f"{ids.shape} do not make one batch")
        if key not in self.prefills:
            self._capturable(f"a prefill of {key[0]} rows x {key[1]} tokens")
            static = StaticInputs({"tokens": key, "lengths": key[:1], "slot_ids": key[:1]},
                                  self.device)
            s = static.views

            def body() -> dict:
                nxt, logits = decode.prefill_into_slots_body(
                    self.params, self.k, self.v, s["tokens"], s["lengths"], s["slot_ids"],
                    self.scale, self.cfg)
                return {"next": nxt, "logits": logits}

            self.prefills[key] = static, GraphedStep(body, pool=self.prefill_pool)
        static, step = self.prefills[key]
        stage(static, {"tokens": tokens, "lengths": lengths, "slot_ids": ids})
        out = step()
        return self.k, self.v, out["next"], out["logits"]

    def decode(self, params, k, v, tokens, positions):
        """decode.decode_step over every cache slot."""
        self._same(params, k, v)
        pos = decode.check_positions(positions, self.k.shape[3])
        tokens = decode.host_index(tokens, "tokens")
        slots = self.k.shape[1]
        if tokens.shape != (slots,) or pos.shape != (slots,):
            raise ValueError(f"a tick feeds every one of the {slots} slots: tokens "
                             f"{tokens.shape}, positions {pos.shape}")
        if self.tick is None:
            self._capturable("the tick")
            static = StaticInputs({"tokens": (slots,), "positions": (slots,)}, self.device)
            s = static.views

            def body() -> dict:
                nxt, logits = decode.decode_step_body(
                    self.params, self.k, self.v, s["tokens"], s["positions"], self.scale,
                    self.cfg)
                return {"next": nxt, "logits": logits}

            self.tick = static, GraphedStep(body)
        static, step = self.tick
        stage(static, {"tokens": tokens, "positions": pos})
        out = step()
        return self.k, self.v, out["next"], out["logits"]

    def adopt(self, new: dict) -> dict:
        """Copy a swapped-in parameter dict (the follower's, of the same
        names, shapes and dtypes) into the captured tensors in place, on
        the current stream: after every replay queued before it, before
        every one queued after. Returns the captured dict."""
        if new is self.params:
            return new
        if new.keys() != self.params.keys():
            raise ValueError("a swapped-in parameter dict must hold the captured names")
        for name, t in self.params.items():
            t.copy_(new[name])
        return self.params
