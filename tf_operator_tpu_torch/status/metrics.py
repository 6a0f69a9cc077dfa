"""Prometheus-style metrics for the port's serving pods: own copy of what
serve/server.py uses from tf_operator_tpu/status/metrics.py.

Counter, Gauge and Histogram (with `labels()` child series, `remove`, and
the bare-sample rule: a family that only ever handed out children exposes
no bare sample) and a Registry whose `expose()` writes the Prometheus text
format: `# HELP` (escaped), `# TYPE`, then the samples, label values
escaped and sorted by key. The `tpujob_serve_*` families carry the JAX
registry's names, help strings, buckets and label rules, because the
router and the collector parse what a replica exposes whichever package
serves it.
"""

from __future__ import annotations

import threading


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str]) -> str:
    """{} -> "", else {a="x",b="y"} sorted by key (deterministic output;
    Prometheus treats label order as insignificant)."""
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _labelset_key(kv: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in kv.items()))


class Counter:
    _kind = "counter"

    def __init__(self, name: str, help_text: str,
                 label_values: dict[str, str] | None = None,
                 labels_only: bool = False):
        self.name = name
        self.help = help_text
        self._v = 0.0
        self._lock = threading.Lock()
        self._label_values = dict(label_values or {})
        self._children: dict[tuple, Counter] = {}
        # Whether the bare (parent) series was ever written. A family
        # with labeled children exposes its bare sample only if someone
        # actually inc()/set() it directly — never a phantom 0. A family
        # declared labels_only never exposes a bare sample at all (it
        # would otherwise show a meaningless 0 until the first child
        # exists, then vanish mid-life — a spurious stale series).
        self._touched = False
        self._labels_only = labels_only

    def labels(self, **kv) -> "Counter":
        """Child series for this label set (created on first use, cached:
        repeated labels(...) with the same values returns the same child,
        so increments accumulate)."""
        if not kv:
            raise ValueError("labels() requires at least one label")
        key = _labelset_key(kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.help, label_values=dict(key))
                self._children[key] = child
            return child

    def remove(self, **kv) -> None:
        """Drop the child series for this label set (no-op when absent).
        Prometheus clients expose this for bounded cardinality: series
        keyed by a finite-lifetime entity (a job) must disappear when the
        entity does, or the family grows without bound."""
        with self._lock:
            self._children.pop(_labelset_key(kv), None)

    def labelsets(self) -> list[dict]:
        """The label sets of every live child series (for pruning)."""
        with self._lock:
            return [dict(k) for k in self._children]

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n
            self._touched = True

    def value(self) -> float:
        with self._lock:
            return self._v

    def _sample_lines(self) -> list[str]:
        return [f"{self.name}{_fmt_labels(self._label_values)} {self.value()}"]

    def expose_lines(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}".rstrip(),
            f"# TYPE {self.name} {self._kind}",
        ]
        with self._lock:
            children = list(self._children.values())
            touched = self._touched
        if touched or (not children and not self._labels_only):
            lines.extend(self._sample_lines())
        for c in children:
            lines.extend(c._sample_lines())
        return lines


class Gauge(Counter):
    _kind = "gauge"

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v
            self._touched = True


class Histogram:
    """Cumulative-bucket histogram, Prometheus semantics: each `le` bucket
    counts observations <= its bound, plus +Inf / _sum / _count series."""

    _kind = "histogram"

    # The JAX registry's default buckets (ms- to seconds-scale).
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)

    def __init__(self, name: str, help_text: str,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                 label_values: dict[str, str] | None = None,
                 labels_only: bool = False):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._lock = threading.Lock()
        self._label_values = dict(label_values or {})
        self._children: dict[tuple, Histogram] = {}
        self._touched = False
        self._labels_only = labels_only

    def labels(self, **kv) -> "Histogram":
        """Child histogram for this label set (shares the bucket layout)."""
        if not kv:
            raise ValueError("labels() requires at least one label")
        key = _labelset_key(kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Histogram(self.name, self.help, buckets=self.buckets,
                                  label_values=dict(key))
                self._children[key] = child
            return child

    def remove(self, **kv) -> None:
        """Drop the child series for this label set (see Counter.remove)."""
        with self._lock:
            self._children.pop(_labelset_key(kv), None)

    def labelsets(self) -> list[dict]:
        with self._lock:
            return [dict(k) for k in self._children]

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._touched = True
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def bucket_counts(self) -> list[int]:
        """Per-bucket (non-cumulative) counts, last entry = +Inf."""
        with self._lock:
            return list(self._counts)

    def _sample_lines(self) -> list[str]:
        with self._lock:
            counts = list(self._counts)
            total = self._sum
        base = dict(self._label_values)
        lines = []
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            lines.append(
                f"{self.name}_bucket{_fmt_labels({**base, 'le': str(b)})} {cum}")
        cum += counts[-1]
        lines.append(
            f"{self.name}_bucket{_fmt_labels({**base, 'le': '+Inf'})} {cum}")
        suffix = _fmt_labels(base)
        lines.append(f"{self.name}_sum{suffix} {total}")
        lines.append(f"{self.name}_count{suffix} {cum}")
        return lines

    def expose_lines(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}".rstrip(),
            f"# TYPE {self.name} {self._kind}",
        ]
        with self._lock:
            children = list(self._children.values())
            touched = self._touched
        if touched or (not children and not self._labels_only):
            lines.extend(self._sample_lines())
        for c in children:
            lines.extend(c._sample_lines())
        return lines


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, Counter | Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "",
                labels_only: bool = False) -> Counter:
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = Counter(name, help_text,
                                              labels_only=labels_only)
            return self._metrics[name]

    def gauge(self, name: str, help_text: str = "",
              labels_only: bool = False) -> Gauge:
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = Gauge(name, help_text,
                                            labels_only=labels_only)
            m = self._metrics[name]
            assert isinstance(m, Gauge)
            return m

    def histogram(self, name: str, help_text: str = "",
                  labels_only: bool = False,
                  buckets: tuple[float, ...] = Histogram.DEFAULT_BUCKETS,
                  ) -> Histogram:
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = Histogram(name, help_text,
                                                buckets=buckets,
                                                labels_only=labels_only)
            m = self._metrics[name]
            assert isinstance(m, Histogram)
            return m

    def names(self) -> list[str]:
        """Every registered metric family name."""
        with self._lock:
            return sorted(self._metrics)

    def expose(self) -> str:
        """Prometheus text exposition format."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.expose_lines())
        return "\n".join(lines) + "\n"


DEFAULT = Registry()

# The InferenceService families (tf_operator_tpu/status/metrics.py's serving
# block, verbatim): the server emits the request, batch, token and follow
# families, one child series per replica; the router and operator-side ones
# are registered so a port replica's /metrics lists what a JAX replica's does
# of this block.
serve_requests_total = DEFAULT.counter(
    "tpujob_serve_requests_total",
    "Inference requests accepted by a serving replica (per replica)",
    labels_only=True,
)
serve_inflight = DEFAULT.gauge(
    "tpujob_serve_inflight",
    "Requests accepted but not yet answered on a serving replica — the "
    "autoscaler's load signal (per replica)",
    labels_only=True,
)
serve_batch_size = DEFAULT.histogram(
    "tpujob_serve_batch_size",
    "Rows per dispatched micro-batch (assembly under batchTimeoutMs up "
    "to batchMaxSize)",
    labels_only=True,
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0),
)
serve_latency_seconds = DEFAULT.histogram(
    "tpujob_serve_latency_seconds",
    "Request latency: accept -> response ready (queue wait + batch "
    "assembly + jitted forward + demux)",
    labels_only=True,
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0),
)
serve_pad_efficiency = DEFAULT.gauge(
    "tpujob_serve_pad_efficiency",
    "Useful units / padded units dispatched by a serving replica "
    "(cumulative; 1.0 = every padded slot carried real work). "
    "Classifiers count rows; generative models count rows + tokens, so "
    "this is the combined 2-D bucketing win signal. Pad-to-max under "
    "light load reads 1/batchMaxSize, bucketed reads near 1.0",
    labels_only=True,
)
serve_token_pad_efficiency = DEFAULT.gauge(
    "tpujob_serve_token_pad_efficiency",
    "Token-dimension slice of pad efficiency on a generative replica: "
    "useful tokens / padded token slots across prefill (seq-len "
    "bucketing win) and decode ticks (slot occupancy)",
    labels_only=True,
)
serve_tokens_total = DEFAULT.counter(
    "tpujob_serve_tokens_total",
    "Tokens generated by a serving replica (prefill first-tokens + one "
    "per active slot per decode tick) — the numerator of tokens/sec",
    labels_only=True,
)
serve_decode_steps_total = DEFAULT.counter(
    "tpujob_serve_decode_steps_total",
    "Decode ticks executed by the continuous-batching scheduler (each "
    "tick advances every active KV slot by one token)",
    labels_only=True,
)
serve_active_slots = DEFAULT.gauge(
    "tpujob_serve_active_slots",
    "KV-cache slots holding an in-flight sequence on a generative "
    "replica (of serving.maxConcurrentSequences) — feeds the router's "
    "least-loaded choice and the autoscaler load signal",
    labels_only=True,
)
serve_router_requests_total = DEFAULT.counter(
    "tpujob_serve_router_requests_total",
    "Requests the front-end router forwarded, per backend replica "
    "(least-time-averaged-inflight choice over READY replicas)",
    labels_only=True,
)
serve_router_hedges_total = DEFAULT.counter(
    "tpujob_serve_router_hedges_total",
    "Hedged sends at the front-end router tier (result: won = the "
    "duplicate answered first | lost = the primary did | suppressed = "
    "the budget expired but the tier was saturated, so no duplicate "
    "was launched). Read-timeouts never hedge",
    labels_only=True,
)
serve_router_affinity_total = DEFAULT.counter(
    "tpujob_serve_router_affinity_total",
    "Session-keyed routing decisions (result: hit = the consistent-hash "
    "ring's home replica was ready and chosen | miss = no ready home, "
    "fell back to least-loaded). hit/(hit+miss) is the affinity hit "
    "ratio — it should stay ~1 outside replica churn",
    labels_only=True,
)
serve_router_ready = DEFAULT.gauge(
    "tpujob_serve_router_ready",
    "Live front-end routers in the service's tier (of "
    "spec.serving.routers; below target means a router died and the "
    "controller is replacing it on the next tick)",
    labels_only=True,
)
serve_ckpt_follow_total = DEFAULT.counter(
    "tpujob_serve_ckpt_follow_total",
    "Checkpoint-follow hot-swaps (result: swapped | error). A swap "
    "replaces the served params between batches with no restart and no "
    "recompile",
    labels_only=True,
)
serve_ready_replicas = DEFAULT.gauge(
    "tpujob_serve_ready_replicas",
    "Running server replicas per InferenceService (operator-side; series "
    "removed when the service is deleted)",
    labels_only=True,
)
serve_scale_events_total = DEFAULT.counter(
    "tpujob_serve_scale_events_total",
    "Autoscale decisions applied (direction: up | down)",
    labels_only=True,
)
