"""Registry export: JSON snapshot and Prometheus text exposition.

JAX counterpart: ``torcheval_tpu/obs/export.py``, ported whole: the same
registry calls give byte-identical text in both packages (the span
families keep their ``torcheval_tpu_span_*`` names, so one dashboard reads
either).

* **JSON** (:func:`to_json`): one self-describing document per scrape, for
  log pipelines and tests.
* **Prometheus text exposition** (:func:`prometheus_text`, version 0.0.4):
  ``# TYPE`` headers, labelled sample lines, spans flattened to ``_count`` /
  ``_seconds_total`` / ``_seconds_max`` plus a ``# TYPE ... histogram``
  family (``torcheval_tpu_span_seconds``) carrying each span path's log2
  latency buckets. Histogram instruments (``obs.histo``) expose as standard
  histogram families: ``<name>_bucket{le=...}`` cumulative counts,
  ``<name>_sum``, ``<name>_count``. Only populated buckets are emitted (plus
  the mandatory ``+Inf`` line). Metric and label names are sanitised to the
  Prometheus charset; span paths ride in a ``path`` label; label values
  escape backslash, double quote and newline.
"""

from __future__ import annotations

import json
import re
from typing import Optional

from torcheval_tpu_torch.obs.registry import Registry, bucket_upper_edge, default_registry

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str) -> str:
    out = _NAME_BAD.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _label_pairs(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_LABEL_BAD.sub("_", k)}="{_escape(v)}"' for k, v in labels
    )
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def to_json(registry: Optional[Registry] = None, *, indent=None) -> str:
    """The registry snapshot as a JSON document string."""
    reg = registry if registry is not None else default_registry
    return json.dumps(reg.snapshot(), indent=indent, sort_keys=True)


def prometheus_text(registry: Optional[Registry] = None) -> str:
    """Prometheus text-format exposition of the registry.

    Counters get ``# TYPE <name> counter``; gauges ``gauge``; histograms a
    ``histogram`` family (cumulative ``_bucket{le=}`` lines over the
    populated log2 edges, ``_sum``, ``_count``); each span path expands into
    three summary-style lines carrying the path as a ``path`` label plus a
    shared ``torcheval_tpu_span_seconds`` histogram family::

        torcheval_tpu_span_count{path="collection.update"} 12
        torcheval_tpu_span_seconds_total{path="collection.update"} 0.0031
        torcheval_tpu_span_seconds_max{path="collection.update"} 0.0009
        torcheval_tpu_span_seconds_bucket{path="collection.update",le="0.000244141"} 9
    """
    reg = registry if registry is not None else default_registry
    # the text format requires every sample of one metric family to form one
    # contiguous group under its # TYPE header — buffer per family first
    # (span samples for different paths share the span family names, and a
    # histogram family's _bucket/_sum/_count lines all live under ONE header)
    families: dict = {}  # family name -> (kind, [sample lines])

    def emit(kind: str, family: str, sample: str, labels, value: float) -> None:
        fam = families.setdefault(family, (kind, []))
        fam[1].append(f"{sample}{_label_pairs(labels)} {value:g}")

    def emit_histogram(family: str, labels, buckets, count, total) -> None:
        cum = 0
        for i, c in enumerate(buckets):
            if not c:
                continue
            cum += c
            le = (("le", f"{bucket_upper_edge(i):g}"),)
            emit(
                "histogram",
                family,
                family + "_bucket",
                tuple(labels) + le,
                cum,
            )
        emit(
            "histogram",
            family,
            family + "_bucket",
            tuple(labels) + (("le", "+Inf"),),
            count,
        )
        emit("histogram", family, family + "_sum", labels, total)
        emit("histogram", family, family + "_count", labels, count)

    for kind, name, labels, value in reg._items():
        if kind == "counter":
            fam = _metric_name(name)
            emit("counter", fam, fam, labels, value)
        elif kind == "gauge":
            fam = _metric_name(name)
            emit("gauge", fam, fam, labels, value)
        elif kind == "histo":  # (buckets, count, sum)
            buckets, count, total = value
            emit_histogram(_metric_name(name), labels, buckets, count, total)
        else:  # span: (count, total_seconds, max_seconds, buckets)
            count, total, mx, buckets = value
            path_labels = (("path", name),) + tuple(labels)
            emit(
                "counter",
                "torcheval_tpu_span_count",
                "torcheval_tpu_span_count",
                path_labels,
                count,
            )
            emit(
                "counter",
                "torcheval_tpu_span_seconds_total",
                "torcheval_tpu_span_seconds_total",
                path_labels,
                total,
            )
            emit(
                "gauge",
                "torcheval_tpu_span_seconds_max",
                "torcheval_tpu_span_seconds_max",
                path_labels,
                mx,
            )
            emit_histogram(
                "torcheval_tpu_span_seconds", path_labels, buckets, count, total
            )
    lines = []
    for name, (kind, samples) in families.items():
        lines.append(f"# TYPE {name} {kind}")
        lines.extend(samples)
    return "\n".join(lines) + ("\n" if lines else "")
