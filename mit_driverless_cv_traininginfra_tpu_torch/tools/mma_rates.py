#!/usr/bin/env python3
"""The int8 tensor cores' rates on one CUDA card, as the port's kernels
drive them: ``mma.sync.m16n8k32`` s8 (K4's 1×1 and K5's 1×1) and
``wgmma.m64nNk32`` s8 with A in registers, B in shared memory (K4, K5's
3×3, ``tail_conv``).

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/mma_rates.py

Builds ``tools/mma_rates.cu`` (which includes ``csrc/int8_mma.cuh``) with
``ops/_lib.py``'s nvcc flags into the git-ignored ``build/``, runs it, and
prints the card's name and power limit, then one JSON line a
configuration: loops of 2000 rounds of independent products on every SM,
timed with CUDA events; TOP/s counts 2 operations a multiply-add.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib  # noqa: E402


def main() -> int:
    cs.phase_device()
    src = Path(__file__).resolve().with_name("mma_rates.cu")
    exe = _lib.BUILD / "mma_rates"
    exe.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _lib.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_lib._nvcc(), *flags, "-I", str(_lib.CSRC), "-o", str(exe), str(src)],
                   check=True)
    return subprocess.run([str(exe)], check=False).returncode


if __name__ == "__main__":
    sys.exit(main())
