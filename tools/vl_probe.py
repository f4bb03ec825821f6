#!/usr/bin/env python3
"""Run the ``lm vl`` and ``lm audio`` phases of ``chip_smoke.py`` alone on
a CUDA card, then the card tests of the two families:

    python3 tools/vl_probe.py

It prints the card's name and power limit, turns TF32 off as the smoke
does, runs ``chip_smoke.vl_phase`` and ``chip_smoke.audio_phase`` (their
``vl ...`` and ``audio ...`` lines and each phase's seconds), then
``tests/test_torch_cuda.py`` restricted to M-RoPE, the non-causal
attention and the xattn decode step.  It exits 1 if a phase or a test
failed, and without a card (the phases need one).
"""

from __future__ import annotations

import os
import pathlib
import subprocess
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
    print(chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    ok = True
    for name, fn in (("lm vl", chip_smoke.vl_phase),
                     ("lm audio", chip_smoke.audio_phase)):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — report and run the next phase
            traceback.print_exc()
            ok = False
        print(f"phase {name} {time.perf_counter() - t0:.3f} s", flush=True)
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "--noconftest",
                        "-p", "no:cacheprovider", "-m", "cuda",
                        "tests/test_torch_cuda.py", "-k",
                        "mrope or non_causal or xattn"], cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    print("tests rc", r.returncode, flush=True)
    return 0 if ok and r.returncode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
