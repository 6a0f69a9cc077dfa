"""The server's forwards as CUDA graphs: the counterpart of the JAX server's
`jax.jit` of prefill_into_slots over its (rows x seq-len) bucket grid and of
its decode tick, each with the KV cache donated
(tf_operator_tpu/serve/server.py:603-630), and of a classifier's bucketed
forward (:545-556).

`serve_route` is the rule: a server on CUDA replays captured graphs; the
CPU runs eagerly, for the reason it returns. There is no flag and no
fallback: a capture or a replay that fails raises.

`GraphedDecode` holds one graph of the decode tick at its one shape (every
cache slot, the whole window) and one graph of prefill_into_slots at each
grid point, each a parallel.graphed_step.GraphedStep over models/decode.py's
device bodies: a point's first call is its warm-up (eager, on the warm-up
stream) and its capture, and every later call a replay. The server makes
those first calls at load, over the grid it warms, then `seal`s: a call at
a shape that was not captured raises. Each callable keeps the eager
function's signature, `(params, k, v, tokens, ...) -> (k, v, next,
logits)`, and its host checks (decode.check_slot_ids, check_positions),
which run before anything is copied. `GraphedForward` is a classifier's:
one graph of the forward and its argmax a row bucket, captured at load.

What a graph reads and writes outlives it: the captured parameter dict (a
checkpoint swap copies the new weights into these tensors in place,
`adopt`), the one KV cache pair (updated in place, as JAX's donation makes
it), the score scale, and each graph's static inputs. A graph's static
inputs are one device buffer (int64 for the decode: tokens, then lengths
and slot ids, or positions; f32 rows for a classifier), written only by
one copy from a pinned host buffer of the same layout, on the current
stream and so after every replay queued before it (graphed_step.stage).
Before the host rewrites a pinned buffer it waits for the event recorded
behind that buffer's last copy: a copy still queued never reads the next
call's values.

Memory: the prefill graphs share one pool, as do a classifier's buckets.
They replay in any order, so a replay may overwrite another graph's
outputs; the tick has a pool of its own. A call's outputs (next tokens,
logits, predictions) are valid until the next call of this object, and the
server reads them at once (to the host) or drops them.
"""

from __future__ import annotations

import numpy as np
import torch

from tf_operator_tpu_torch.models import decode
from tf_operator_tpu_torch.parallel.graphed_step import GraphedStep, StaticInputs, stage


def serve_route(device_type: str, generative: bool) -> tuple[str, str]:
    """("graph" or "eager", why) for a server on `device_type` serving a
    generative model or a classifier."""
    if device_type != "cuda":
        return "eager", "CUDA graphs exist only on a CUDA device"
    if not generative:
        return "graph", ("a classifier on CUDA: each row bucket's forward and argmax "
                         "replays one captured CUDA graph")
    return "graph", ("a generative model on CUDA: each decode tick and each prefill grid "
                     "point replays one captured CUDA graph")


def adopt(captured: dict, new: dict) -> dict:
    """Copy a swapped-in parameter dict (the follower's, of the same names,
    shapes and dtypes) into the `captured` tensors in place, on the
    current stream: after every replay queued before it, before every one
    queued after. Returns the captured dict."""
    if new is captured:
        return new
    if new.keys() != captured.keys():
        raise ValueError("a swapped-in parameter dict must hold the captured names")
    for name, t in captured.items():
        t.copy_(new[name])
    return captured


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
        """adopt() into the captured parameter dict."""
        return adopt(self.params, new)


class GraphedForward:
    """apply(params, rows), a classifier server's forward on the graph
    route: `model`'s forward over `params` (the dict every graph reads) and
    the argmax of its logits, one GraphedStep a row bucket, fed from one f32
    StaticInputs a bucket; returns the predictions on the host (int64)."""

    def __init__(self, model: torch.nn.Module, params: dict, input_shape: tuple,
                 device: torch.device):
        self.model = model
        self.params = params
        self.input_shape = tuple(input_shape)
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.buckets: dict[int, tuple[StaticInputs, GraphedStep]] = {}
        self.sealed = False

    def seal(self) -> None:
        """No more captures: a bucket not captured raises."""
        self.sealed = True

    def forward(self, params, rows) -> dict:
        """The graph's outputs for `rows` (a host f32 array of a bucket's
        shape): {"logits", "pred"} on the device, valid until the next
        call."""
        if params is not self.params:
            raise RuntimeError("the classifier graphs were captured on another parameter dict")
        rows = np.asarray(rows, np.float32)
        if rows.shape[1:] != self.input_shape:
            raise ValueError(f"rows of shape {rows.shape[1:]}; the graphs take "
                             f"{self.input_shape}")
        n = rows.shape[0]
        if n not in self.buckets:
            if self.sealed:
                raise ValueError(f"a batch of {n} rows is outside the captured buckets "
                                 f"{sorted(self.buckets)}")
            static = StaticInputs({"x": rows.shape}, self.device, torch.float32)
            x = static.views["x"]

            def body() -> dict:
                logits = torch.func.functional_call(self.model, self.params, (x,))
                return {"logits": logits, "pred": logits.argmax(-1)}

            self.buckets[n] = static, GraphedStep(body, pool=self.pool)
        static, step = self.buckets[n]
        stage(static, {"x": rows})
        return step()

    def __call__(self, params, rows) -> np.ndarray:
        return self.forward(params, rows)["pred"].cpu().numpy()

    def adopt(self, new: dict) -> dict:
        """adopt() into the captured parameter dict."""
        return adopt(self.params, new)
