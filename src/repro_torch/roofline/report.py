"""Write the roofline tables of one or two dry runs to a file, the port
of ``repro.roofline.report`` (which fills placeholders of an
``EXPERIMENTS.md`` that this repo does not have):

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        --baseline results/dryrun [--optimized results/dryrun_v2] \\
        [--mesh single] [--out results/roofline.md]
"""

from __future__ import annotations

import argparse
import os

from repro_torch.launch.mesh import HW
from repro_torch.roofline.analysis import analyze_dir, markdown_table


def table_for(dry_dir: str, mesh: str = "single") -> str:
    rows, skips, errors = analyze_dir(dry_dir, mesh)
    skip_lines = [f"* skipped: {s['arch']} × {s['shape']} — "
                  f"{s.get('reason', '')[:80]}…" for s in skips]
    error_lines = [f"* error: {e['arch']} × {e['shape']} — "
                   f"{e.get('error', '')[:120]}" for e in errors]
    out = markdown_table(rows)
    out += (f"\n\n{len(rows)} cells ran, {len(skips)} skipped by "
            f"assignment rule, {len(errors)} errors.\n")
    for lines in (skip_lines, error_lines):
        if lines:
            out += "\n" + "\n".join(sorted(set(lines))) + "\n"
    return out


def render(baseline: str, optimized: str | None = None,
           mesh: str = "single") -> str:
    hw = ", ".join(f"{k} {v}" for k, v in HW.items())
    doc = (f"# Roofline ({mesh} mesh)\n\nCard (datasheet constants, not "
           f"measured): {hw}.\n\n## {baseline}\n\n"
           + table_for(baseline, mesh))
    if optimized:
        doc += f"\n## {optimized}\n\n" + table_for(optimized, mesh)
    return doc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default="results/dryrun")
    ap.add_argument("--optimized", default=None)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="results/roofline.md")
    args = ap.parse_args()
    doc = render(args.baseline, args.optimized, args.mesh)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(doc)
    print(f"wrote the roofline tables to {args.out}")


if __name__ == "__main__":
    main()
