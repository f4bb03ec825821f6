#!/usr/bin/env python3
"""Run the ``lm dp`` and ``lm tp`` phases of ``chip_smoke.py`` alone on a
CUDA card:

    python3 tools/parallel_probe.py

It prints the card's name and power limit, builds the kernels as the
smoke does, turns TF32 off, runs ``chip_smoke.dp_phase`` and
``chip_smoke.tp_phase`` (their ``lm dp ...`` and ``lm tp ...`` lines and
each phase's seconds) and exits 1 if a phase failed, and without a card.
"""

from __future__ import annotations

import pathlib
import sys
import time
import traceback

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda_lib

    print(chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    cuda_lib.build()
    print(f"build {time.perf_counter() - t0:.3f} s", flush=True)
    ok = True
    for name, fn in (("lm dp", chip_smoke.dp_phase),
                     ("lm tp", chip_smoke.tp_phase)):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — report and run the next phase
            traceback.print_exc()
            ok = False
        print(f"phase {name} {time.perf_counter() - t0:.3f} s", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
