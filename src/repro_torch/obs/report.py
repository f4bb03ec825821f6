"""Pretty-print observability artifacts (DESIGN.md §13), the port's copy
of ``repro.obs.report``.

    PYTHONPATH=src python -m repro_torch.obs.report metrics.json
    PYTHONPATH=src python -m repro_torch.obs.report trace.json

Auto-detects the artifact kind: a Chrome trace (``traceEvents`` key, as
``obs.save_chrome_trace`` writes it) is summarised per span name (count,
total, mean, max); a metrics snapshot (``counters``/``gauges``/
``histograms`` keys, as ``obs.save_metrics`` writes it) is printed as
aligned tables with p50/p90 estimates for histograms.
"""

from __future__ import annotations

import argparse
import json
import sys


def _quantile(edges, counts, total, q, vmax):
    """Bucket-walk quantile matching metrics.Histogram.quantile."""
    if not total:
        return 0.0
    rank = q * total
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= rank and c:
            return edges[i] if i < len(edges) else vmax
    return vmax


def summarize_trace(payload: dict, out=None):
    out = out if out is not None else sys.stdout
    evs = payload.get("traceEvents", [])
    by_name: dict[str, list] = {}
    n_async = n_instant = 0
    for e in evs:
        if e.get("ph") == "X":
            by_name.setdefault(e["name"], []).append(float(e.get("dur", 0.0)))
        elif e.get("ph") in ("b", "e"):
            n_async += 1
        elif e.get("ph") == "i":
            n_instant += 1
    print(f"trace: {len(evs)} events ({sum(map(len, by_name.values()))} "
          f"spans, {n_async} async, {n_instant} instant)", file=out)
    print(f"{'span':<32}{'count':>8}{'total_ms':>12}{'mean_us':>12}"
          f"{'max_us':>12}", file=out)
    for name, durs in sorted(by_name.items(),
                             key=lambda kv: -sum(kv[1])):
        total = sum(durs)
        print(f"{name:<32}{len(durs):>8}{total/1e3:>12.3f}"
              f"{total/len(durs):>12.1f}{max(durs):>12.1f}", file=out)


def summarize_metrics(payload: dict, out=None):
    out = out if out is not None else sys.stdout
    counters = payload.get("counters", {})
    gauges = payload.get("gauges", {})
    hists = payload.get("histograms", {})
    if counters:
        print("counters:", file=out)
        for name, v in sorted(counters.items()):
            print(f"  {name:<40}{v:>16}", file=out)
    if gauges:
        print("gauges:", file=out)
        for name, v in sorted(gauges.items()):
            print(f"  {name:<40}{v:>16g}", file=out)
    if hists:
        print("histograms:", file=out)
        for name, h in sorted(hists.items()):
            count = h.get("count", 0)
            mean = h["sum"] / count if count else 0.0
            vmax = h.get("max") or 0.0
            p50 = _quantile(h["buckets"], h["counts"], count, 0.5, vmax)
            p90 = _quantile(h["buckets"], h["counts"], count, 0.9, vmax)
            print(f"  {name:<40} count={count} mean={mean:.6g} "
                  f"p50<={p50:.6g} p90<={p90:.6g} max={vmax:.6g}",
                  file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs.report")
    ap.add_argument("path", help="a Chrome trace or a metrics snapshot")
    args = ap.parse_args(argv)
    try:
        with open(args.path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"[report] cannot read {args.path}: {exc}", file=sys.stderr)
        return 1
    if not isinstance(payload, dict):
        print(f"[report] {args.path}: not an observability artifact",
              file=sys.stderr)
        return 1
    if "traceEvents" in payload:
        summarize_trace(payload)
        return 0
    if {"counters", "gauges", "histograms"} & set(payload):
        summarize_metrics(payload)
        return 0
    print(f"[report] {args.path}: neither a Chrome trace nor a metrics "
          f"snapshot", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
