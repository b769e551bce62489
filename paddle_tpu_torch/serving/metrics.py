"""Serving-engine metrics: counters and histograms as plain dicts, and
their Prometheus text exposition.

Copy of ``paddle_tpu/serving/metrics.py`` (numpy and the standard
library only). ``snapshot()`` returns a plain dict; ``expose()`` renders
the same state as dependency-free Prometheus text (format 0.0.4), and
``merge_exposition`` renders many sources, or scrape texts parsed back
(``_parse_exposition``), as one scrape.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from .locktrace import wrap_lock

__all__ = ["Histogram", "ServingMetrics", "merge_exposition"]


class Histogram:
    """Windowed-reservoir histogram over the last ``cap`` observations:
    ``count``/``mean`` are lifetime; ``window_mean``/``p50``/``p99``/
    ``max`` cover only the window."""

    def __init__(self, cap: int = 65536):
        self._vals: "deque" = deque(maxlen=int(cap))
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self._count += 1
        self._sum += v
        self._vals.append(v)

    @property
    def lifetime_sum(self) -> float:
        return self._sum

    def summary(self) -> Dict[str, float]:
        if not self._vals:
            return {"count": 0, "mean": 0.0, "window_count": 0,
                    "window_mean": 0.0, "p50": 0.0, "p99": 0.0,
                    "max": 0.0}
        a = np.asarray(self._vals, np.float64)
        return {"count": self._count,
                "mean": self._sum / self._count,
                "window_count": int(a.size),
                "window_mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "max": float(a.max())}


def _prom_escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n") \
                 .replace('"', r'\"')


class ServingMetrics:
    """Counters + histograms for the continuous-batching engine.

    Counters: request lifecycle (submitted/admitted/completed/cancelled/
    timed_out/rejected), work units (ticks — engine ticks that ran the
    model, prefills, prefill_chunks, decode_steps — decode steps taken
    while streams were live, model_steps — forward passes of the whole
    model the engine ran, tokens_out), prefix-cache effectiveness
    (prefix_hits / prefix_misses per admission, prefix_hit_tokens —
    prompt tokens not recomputed, prefix_pages_saved — pages attached
    instead of allocated) and speculative decoding (spec_ticks — verify
    launches; draft_tokens / draft_accepted / draft_rejected — per draft
    token), the invariants audit (invariant_violations), the hand-back
    drain (handed_back) and the cold tier (cold_hits / cold_hit_pages —
    rewarms and the pages they re-adopted — and cold_spills — pages
    paged out), and the recompile sentinel's alarms (recompiles: kernel
    library loads after ``arm()``, also labeled by the span they
    interrupted).
    Labeled counters (``inc_labeled``): the same monotonic semantics
    with a small label set, exposed as their own
    ``*_breakdown_total`` Prometheus family so aggregating either family
    never double-counts.
    Histograms: queue_wait_s (submit -> admission), ttft_s (submit ->
    first token), decode_step_s (one engine tick per decode step),
    decode_stall_s (gap between consecutive decode ticks while streams
    are live), batch_occupancy, page_utilization and chunk_queue_depth
    (sampled per tick), spec_accept_rate (accepted / drafted per verify
    launch) and cold_adopt_s (one cold-tier rewarm: the eviction that
    makes room, then the pages' scatter and graft).
    Summaries report the lifetime mean and the windowed mean and
    percentiles separately (:class:`Histogram`).
    """

    COUNTERS = ("submitted", "admitted", "completed", "cancelled",
                "timed_out", "rejected", "ticks", "prefills",
                "prefill_chunks", "decode_steps", "model_steps",
                "tokens_out", "prefix_hits", "prefix_misses",
                "prefix_hit_tokens", "prefix_pages_saved",
                "invariant_violations", "recompiles", "spec_ticks",
                "draft_tokens", "draft_accepted", "draft_rejected",
                "handed_back", "cold_hits", "cold_hit_pages",
                "cold_spills")
    HISTOGRAMS = ("queue_wait_s", "ttft_s", "decode_step_s",
                  "decode_stall_s", "batch_occupancy",
                  "page_utilization", "chunk_queue_depth",
                  "spec_accept_rate", "cold_adopt_s")

    def __init__(self):
        self._lock = wrap_lock(threading.Lock(), "ServingMetrics._lock")
        self.counters = {k: 0 for k in self.COUNTERS}
        self.histograms = {k: Histogram() for k in self.HISTOGRAMS}
        # name -> {tuple(sorted(label items)) -> count}
        self.labeled: Dict[str, Dict[Tuple[Tuple[str, str], ...], int]] \
            = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def inc_labeled(self, name: str, n: int = 1, **labels) -> None:
        """Monotonic labeled counter, e.g.
        ``inc_labeled("recompiles", during="serving.tick")``."""
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            series = self.labeled.setdefault(name, {})
            series[key] = series.get(key, 0) + n

    def observe(self, name: str, v: float) -> None:
        with self._lock:
            self.histograms[name].observe(v)

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict export: {'counters': {...}, 'labeled': {name:
        [{labels, value}]}, 'histograms': {name: {count, mean,
        window_count, window_mean, p50, p99, max}}}."""
        with self._lock:
            return {"counters": dict(self.counters),
                    "labeled": {
                        name: [{"labels": dict(key), "value": v}
                               for key, v in sorted(series.items())]
                        for name, series in self.labeled.items()},
                    "histograms": {k: h.summary()
                                   for k, h in self.histograms.items()}}

    # -------------------------------------------------- prometheus text ----
    def _collect(self):
        """One consistent read of every series under the lock:
        ``(counters, labeled, {hist: (summary, lifetime_sum)})`` —
        the raw material both :meth:`expose` and the fleet-level
        :func:`merge_exposition` render from (values stay RAW here;
        label escaping happens exactly once, at render time)."""
        with self._lock:
            return (dict(self.counters),
                    {n: dict(s) for n, s in self.labeled.items()},
                    {k: (h.summary(), h.lifetime_sum)
                     for k, h in self.histograms.items()})

    def expose(self, prefix: str = "paddle_serving",
               gauges: Optional[Dict[str, float]] = None,
               labels: Optional[Dict[str, str]] = None) -> str:
        """Dependency-free Prometheus text exposition (format 0.0.4).

        Flat counters become ``<prefix>_<name>_total``; labeled
        counters become their OWN family
        ``<prefix>_<name>_breakdown_total`` — never samples of the
        flat family, because mixing an unlabeled total with labeled
        slices of the same quantity in one family makes
        ``sum(rate(...))`` double-count (and mixing empty/non-empty
        label sets violates the Prometheus data model). Histograms
        become summaries — ``{quantile="0.5"|"0.99"}`` windowed
        quantiles plus LIFETIME ``_sum``/``_count`` (the Prometheus
        summary contract: _sum/_count are monotonic lifetime series a
        scraper can rate(); quantiles are the recent window).
        ``gauges`` (optional {name: value}) are emitted as
        ``<prefix>_<name>`` gauge samples — the engine passes its live
        pool/queue gauges. A gauge whose name collides with a
        histogram family (e.g. the live ``page_utilization`` gauge vs
        the per-tick ``page_utilization`` histogram) is emitted as
        ``<prefix>_<name>_now``: one metric family must not carry two
        TYPEs, or the whole scrape is rejected.

        ``labels`` (optional {name: value}) are stamped onto EVERY
        sample — the fleet aggregator passes ``{"replica": ...}``.
        Values are passed RAW and escaped exactly once at render time,
        so re-exporting through the fleet can never double-escape.
        """
        return merge_exposition([(labels or {}, self, gauges)],
                                prefix=prefix)


def _prom_unescape(v: str) -> str:
    """Exact inverse of :func:`_prom_escape` (label values parsed back
    to RAW strings, so a re-render escapes exactly once again)."""
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(
                nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


_SAMPLE_RE = None     # compiled lazily (module import stays regex-free
#                       for the serving hot path; parsing is scrape-time)


def _parse_exposition(text: str, prefix: str) -> dict:
    """Parse Prometheus text exposition (the format ``expose()`` /
    :func:`merge_exposition` render) back into the merge's internal
    families — the REMOTE-worker half of fleet aggregation
    (fleet/proc/): a worker process ships its scrape as text, and the
    parent merges it with local entries under the same
    one-TYPE-line-per-family and escape-once guarantees.

    Returns ``{"counters"|"breakdowns"|"summaries"|"gauges":
    {name: samples}}`` with family names STRIPPED of ``prefix`` and
    kind suffixes, label values unescaped to raw, and summary samples
    regrouped into ``(labels, {"p50","p99","count"}, lifetime_sum)``
    triples. A gauge the worker renamed ``<name>_now`` (histogram
    collision) is un-renamed when its base family is a summary in the
    same text, so the merged render applies the collision rename
    exactly once, globally."""
    global _SAMPLE_RE
    if _SAMPLE_RE is None:
        import re
        _SAMPLE_RE = (
            re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
                       r"(?:\{(.*)\})? (\S+)$"),
            re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'))
    sample_re, label_re = _SAMPLE_RE
    kinds: Dict[str, str] = {}
    raw = []                            # (metric, labels, value) in order
    for ln in text.splitlines():
        if not ln.strip():
            continue
        if ln.startswith("# TYPE "):
            parts = ln.split(" ")
            if len(parts) == 4:
                kinds[parts[2]] = parts[3]
            continue
        if ln.startswith("#"):
            continue                    # HELP/comment lines
        m = sample_re.match(ln)
        if not m:
            raise ValueError(f"unparseable exposition sample: {ln!r}")
        metric, lbl, val = m.groups()
        labels = {k: _prom_unescape(v)
                  for k, v in label_re.findall(lbl)} if lbl else {}
        raw.append((metric, labels, float(val)))

    def strip(metric: str, suffix: str = "") -> str:
        name = metric[len(prefix) + 1:]
        return name[:-len(suffix)] if suffix else name

    def family_of(metric: str) -> str:
        """Owning family: ``X_sum``/``X_count`` belong to summary
        family ``X``."""
        for suf in ("_sum", "_count"):
            if metric.endswith(suf) and \
                    kinds.get(metric[:-len(suf)]) == "summary":
                return metric[:-len(suf)]
        return metric

    out = {"counters": {}, "breakdowns": {}, "summaries": {},
           "gauges": {}}
    # summaries need regrouping: (family, label-key minus quantile) ->
    # accumulating {p50, p99, sum, count}
    summ: Dict[tuple, dict] = {}
    for metric, labels, val in raw:
        fam = family_of(metric)
        kind = kinds.get(fam)
        if kind is None or not fam.startswith(prefix + "_"):
            raise ValueError(
                f"sample {metric!r} has no TYPE line (family {fam!r})")
        if kind == "counter":
            ival = int(val) if val == int(val) else val
            if fam.endswith("_breakdown_total"):
                out["breakdowns"].setdefault(
                    strip(fam, "_breakdown_total"), []).append(
                        (labels, ival))
            else:
                out["counters"].setdefault(
                    strip(fam, "_total"), []).append((labels, ival))
        elif kind == "summary":
            base = dict(labels)
            q = base.pop("quantile", None)
            key = (strip(fam),
                   tuple(sorted(base.items())))
            acc = summ.setdefault(key, {"labels": base, "p50": 0.0,
                                        "p99": 0.0, "sum": 0.0,
                                        "count": 0})
            if metric.endswith("_sum") and fam != metric:
                acc["sum"] = val
            elif metric.endswith("_count") and fam != metric:
                acc["count"] = int(val)
            elif q == "0.5":
                acc["p50"] = val
            elif q == "0.99":
                acc["p99"] = val
        elif kind == "gauge":
            out["gauges"].setdefault(strip(fam), []).append(
                (labels, val))
        else:
            raise ValueError(f"unsupported TYPE {kind!r} for {fam!r}")
    for (name, _), acc in summ.items():
        out["summaries"].setdefault(name, []).append(
            (acc["labels"],
             {"p50": acc["p50"], "p99": acc["p99"],
              "count": acc["count"]},
             acc["sum"]))
    # un-rename collision gauges (see docstring): raw name goes back in
    # so the merged render's collision check fires exactly once
    for gname in list(out["gauges"]):
        if gname.endswith("_now") and gname[:-4] in out["summaries"]:
            out["gauges"].setdefault(gname[:-4], []).extend(
                out["gauges"].pop(gname))
    return out


def _render_labels(labels: Dict[str, str]) -> str:
    """``k1="v1",k2="v2"`` with values escaped HERE and nowhere else
    (the escape-once contract: callers always hand raw values)."""
    return ",".join(f'{k}="{_prom_escape(v)}"'
                    for k, v in sorted(labels.items()))


def _sample(metric: str, labels: Dict[str, str], value: str) -> str:
    lbl = _render_labels(labels)
    return f"{metric}{{{lbl}}} {value}" if lbl else f"{metric} {value}"


def merge_exposition(entries, prefix: str = "paddle_serving") -> str:
    """Render MANY metrics sources as ONE Prometheus scrape.

    ``entries`` is ``[(labels, metrics, gauges)]``: per entry, a raw
    (unescaped) label dict stamped on every sample (the fleet passes
    ``{"replica": "r0"}``), a :class:`ServingMetrics`, a raw scrape
    TEXT ``str`` (a remote worker's own ``expose()`` output, shipped
    over the fleet/proc transport and parse-merged here), or ``None``,
    and an optional ``{name: value}`` gauge dict. The single-engine
    :meth:`ServingMetrics.expose` is exactly this with one entry, and
    ``merge_exposition([({}, expose_text, None)])`` is byte-identical
    to ``expose_text`` (parse/render round-trips).

    Aggregation rules (the reasons this is structured merging, not
    text concatenation):

    * one ``# TYPE`` line per family, however many entries sample it —
      repeated TYPE lines for one family make a scrape invalid;
    * label values are escaped exactly ONCE, here: entries hand raw
      values, so a fleet re-exporting per-replica metrics can never
      double-escape what an engine already escaped;
    * deterministic ordering — families sorted by kind (counters,
      labeled breakdowns, histogram summaries, gauges) then name,
      samples within a family sorted by rendered label string — so two
      renders of the same state are byte-identical (diffable scrapes);
    * an entry's labels override same-named labels from a labeled
      counter's own key (the aggregator owns the ``replica`` axis);
    * gauge names colliding with a histogram family anywhere in the
      merge are renamed ``<name>_now`` (one family, one TYPE).
    """
    fam_counter: Dict[str, list] = {}
    fam_break: Dict[str, list] = {}
    fam_hist: Dict[str, list] = {}
    fam_gauge: Dict[str, list] = {}
    for labels, metrics, gauges in entries:
        base = {str(k): str(v) for k, v in (labels or {}).items()}
        if isinstance(metrics, str):
            # raw scrape TEXT from a remote worker (fleet/proc/):
            # parse back into families so the TYPE-line and escape
            # guarantees hold across the process boundary too
            parsed = _parse_exposition(metrics, prefix)
            for name, samples in parsed["counters"].items():
                for lbls, v in samples:
                    merged = dict(lbls)
                    merged.update(base)
                    fam_counter.setdefault(name, []).append((merged, v))
            for name, samples in parsed["breakdowns"].items():
                for lbls, v in samples:
                    merged = dict(lbls)
                    merged.update(base)
                    fam_break.setdefault(name, []).append((merged, v))
            for name, triples in parsed["summaries"].items():
                for lbls, s, life_sum in triples:
                    merged = dict(lbls)
                    merged.update(base)
                    fam_hist.setdefault(name, []).append(
                        (merged, s, life_sum))
            for name, samples in parsed["gauges"].items():
                for lbls, v in samples:
                    merged = dict(lbls)
                    merged.update(base)
                    fam_gauge.setdefault(name, []).append((merged, v))
        elif metrics is not None:
            counters, labeled, hists = metrics._collect()
            for name, v in counters.items():
                fam_counter.setdefault(name, []).append((base, v))
            for name, series in labeled.items():
                for key, lv in series.items():
                    merged = dict(key)
                    merged.update(base)
                    fam_break.setdefault(name, []).append((merged, lv))
            for name, (s, life_sum) in hists.items():
                fam_hist.setdefault(name, []).append((base, s, life_sum))
        for name, v in (gauges or {}).items():
            fam_gauge.setdefault(name, []).append((base, float(v)))
    lines = []
    for name in sorted(fam_counter):
        metric = f"{prefix}_{name}_total"
        lines.append(f"# TYPE {metric} counter")
        for base, v in sorted(fam_counter[name],
                              key=lambda e: _render_labels(e[0])):
            lines.append(_sample(metric, base, str(v)))
    for name in sorted(fam_break):
        metric = f"{prefix}_{name}_breakdown_total"
        lines.append(f"# TYPE {metric} counter")
        for lbls, v in sorted(fam_break[name],
                              key=lambda e: _render_labels(e[0])):
            lines.append(_sample(metric, lbls, str(v)))
    for name in sorted(fam_hist):
        metric = f"{prefix}_{name}"
        lines.append(f"# TYPE {metric} summary")
        for base, s, life_sum in sorted(
                fam_hist[name], key=lambda e: _render_labels(e[0])):
            for q, val in (("0.5", s["p50"]), ("0.99", s["p99"])):
                lines.append(_sample(metric, dict(base, quantile=q),
                                     f"{val:.9g}"))
            lines.append(_sample(f"{metric}_sum", base,
                                 f"{life_sum:.9g}"))
            lines.append(_sample(f"{metric}_count", base,
                                 str(s["count"])))
    for name in sorted(fam_gauge):
        out_name = f"{name}_now" if name in fam_hist else name
        metric = f"{prefix}_{out_name}"
        lines.append(f"# TYPE {metric} gauge")
        for base, v in sorted(fam_gauge[name],
                              key=lambda e: _render_labels(e[0])):
            lines.append(_sample(metric, base, f"{v:.9g}"))
    return "\n".join(lines) + "\n"
