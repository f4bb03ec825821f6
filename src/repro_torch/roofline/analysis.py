"""The roofline of the dry run's cells, the port of
``repro.roofline.analysis``.

Reads the dry run's JSONs (``launch.dryrun``) and derives, per (arch ×
shape × mesh), the three lower bounds of a step's time on the card of
``launch.mesh.HW`` (an H100's datasheet constants):

    compute term    = sum over dtypes of FLOPs_dtype / the card's peak
                      for that dtype (bf16: the tensor cores' dense rate;
                      f32: the CUDA cores', the port running TF32 off)
    memory term     = HBM bytes per rank / hbm_bw
    collective term = collective bytes per rank / link_bw

the dominant term, MODEL_FLOPS = 6·N·D (train) / 2·N·D (serve) with N =
active parameters, the useful-compute ratio MODEL_FLOPS / counted FLOPs,
and a one-line recommendation for the dominant term.  The reference
charges every FLOP at one bf16 peak; on this card that would put an f32
cell's compute bound 15x too low, so each dtype takes its own.

The FLOPs, bytes and collective bytes are ``roofline.cost``'s counts;
the bytes are the eager upper bound (there is no fusion-calibrated
count), so the memory term is an upper bound of the memory floor.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass

from repro_torch.launch.mesh import HW


@dataclass
class Row:
    arch: str
    shape: str
    mesh: str
    kind: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_dev: float
    hlo_flops_dev: float
    useful_ratio: float
    fraction_of_peak: float
    note: str
    raw: dict

    @property
    def bound_s(self) -> float:
        """The roofline's lower bound: the largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def peak_flops(dtype: str, hw: dict = HW) -> float:
    """The card's peak rate for products in ``dtype``: the tensor cores'
    for bf16 and f16, the CUDA cores' f32 rate for everything else."""
    return hw["peak_flops_bf16"] if dtype in ("bfloat16", "float16") \
        else hw["peak_flops_f32"]


def terms(flops_by_dtype: dict, bytes_hbm: float, coll_bytes: float,
          hw: dict = HW) -> dict:
    """{"compute", "memory", "collective"} in seconds."""
    return {"compute": sum(f / peak_flops(d, hw)
                           for d, f in flops_by_dtype.items()),
            "memory": bytes_hbm / hw["hbm_bw"],
            "collective": coll_bytes / hw["link_bw"]}


def model_flops(meta: dict) -> float:
    """Analytic MODEL_FLOPS (global): 6·N·D train, 2·N·D serve."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.lm import count_active_params
    arch, kind = meta["arch"], meta["kind"]
    if meta.get("family") == "vision":
        # 2 * MACs * batch (fwd) [* 3 for train]
        import dataclasses

        from repro_torch.configs.gspn2_vision import VISION_CONFIGS
        from repro_torch.models.vision import vision_macs
        vcfg = dataclasses.replace(VISION_CONFIGS[arch],
                                   img_size=meta["seq_len"])
        per_img = 2 * vision_macs(vcfg)
        mult = 3 if kind == "train" else 1
        return per_img * meta["global_batch"] * mult
    n = count_active_params(get_arch(arch).full())
    if kind == "train":
        tokens = meta["global_batch"] * meta["seq_len"]
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = meta["global_batch"] * meta["seq_len"]
        return 2.0 * n * tokens
    tokens = meta["global_batch"]          # one new token per sequence
    return 2.0 * n * tokens


def _note(dominant: str, row: dict) -> str:
    coll = row.get("collectives", {})
    biggest_coll = max(
        ((k, v) for k, v in coll.items()
         if k not in ("total", "count")), key=lambda kv: kv[1],
        default=("-", 0))[0]
    if dominant == "collective":
        return (f"dominant collective is {biggest_coll}; reduce via "
                "sharding that keeps the tensor local (e.g. move the "
                "reduction onto the FSDP axis / overlap with compute)")
    if dominant == "memory":
        return ("HBM-bound: shrink resident residuals (remat policy, "
                "bf16 residuals) or raise arithmetic intensity (fuse "
                "cache update with attention read)")
    return ("compute-bound: good — push useful-ratio toward 1 by "
            "trimming remat recompute and redundant casts")


def analyze_dir(dry_dir: str, mesh: str = "single"):
    rows, skips, errors = [], [], []
    for path in sorted(glob.glob(os.path.join(dry_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("mesh") != mesh:
            continue
        if rec.get("status") == "skipped":
            skips.append(rec)
            continue
        if rec.get("status") != "ok":
            errors.append(rec)
            continue
        meta = rec["meta"]
        n_dev = rec["n_devices"]
        flops_dev = rec["flops"]
        t = terms(rec.get("flops_by_dtype") or {"bfloat16": flops_dev},
                  rec.get("bytes_hbm_calibrated") or rec["bytes_hbm"],
                  rec["collectives"]["total"])
        dominant = max(t, key=t.get)
        mf = model_flops(meta) / n_dev
        useful = mf / flops_dev if flops_dev else 0.0
        frac = t["compute"] / max(max(t.values()), 1e-30)
        rows.append(Row(
            arch=meta["arch"], shape=meta["shape"], mesh=mesh,
            kind=meta["kind"], compute_s=t["compute"], memory_s=t["memory"],
            collective_s=t["collective"], dominant=dominant,
            model_flops_dev=mf, hlo_flops_dev=flops_dev,
            useful_ratio=useful, fraction_of_peak=frac,
            note=_note(dominant, rec), raw=rec))
    return rows, skips, errors


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | compute | memory | collective | dominant | "
           "MODEL_FLOPs/dev | useful | peak-frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in sorted(rows, key=lambda r: (r.arch, r.shape)):
        lines.append(
            f"| {r.arch} | {r.shape} | {fmt_s(r.compute_s)} | "
            f"{fmt_s(r.memory_s)} | {fmt_s(r.collective_s)} | "
            f"**{r.dominant}** | {r.model_flops_dev:.2e} | "
            f"{r.useful_ratio:.2f} | {r.fraction_of_peak:.2f} |")
    return hdr + "\n".join(lines)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    rows, skips, errors = analyze_dir(args.dir, args.mesh)
    print(markdown_table(rows))
    print(f"\n{len(rows)} cells, {len(skips)} skipped, "
          f"{len(errors)} errors")
    for r in sorted(rows, key=lambda r: r.fraction_of_peak)[:5]:
        print(f"worst: {r.arch}×{r.shape} frac={r.fraction_of_peak:.2f} "
              f"dom={r.dominant} — {r.note}")


if __name__ == "__main__":
    main()
