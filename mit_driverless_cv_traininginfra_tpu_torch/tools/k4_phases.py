#!/usr/bin/env python3
"""Where K4's time goes: ``csrc/entry_block.cu`` built three ways and run
on the main path's (8, 208, 208, 128) int8 ``hq``.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/k4_phases.py

- ``kernel``: the source as it is (its output checked bit for bit against
  the plain ``ops/entry.py:_entry_rest``);
- ``cycles``: the same with ``clock64()`` read by thread 0 of block 0 after
  each phase barrier: the window wait, conv2p, the 1×1, the 3×3 and the
  output copy, summed over that block's tiles;
- ``no_epilogue``: every dequant / leaky / requant replaced by a bit copy
  (wrong values, same products, loads and stores), with its cycles.

Each copy is compiled with ``ops/_lib.py``'s nvcc flags into its own
library under the git-ignored ``build/k4_phases/``; times are CUDA events
over 50 calls, in the order kernel, no_epilogue, no_epilogue, kernel.
Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib, entry  # noqa: E402

PHASES = ("wait", "conv2p", "1x1", "3x3", "out")
# the barrier that ends each phase, and the end of the tile loop
ANCHORS = ("    __syncthreads();\n    const unsigned char* sHq",
           "    __syncthreads();\n\n    // ---- 1×1",
           "    __syncthreads();\n\n    // ---- 3×3",
           "    __syncthreads();\n    // each output row")
LOOP_END = "    buf ^= 1;"
Q8_BODY = ("  const float r = rintf(__fmul_rn(v, sx_inv));\n"
           "  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));")
DEQ_BODY = ("  const float y32 = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);\n"
            "  const __nv_bfloat16 y = __float2bfloat16_rn(y32);\n"
            "  return y32 >= 0.f ? y : __float2bfloat16_rn(__fmul_rn(__bfloat162float(y), slope));")


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"entry_block.cu no longer holds {old!r}")
    return src.replace(old, new, 1)


def with_cycles(src: str) -> str:
    """The source with a phase clock in block 0 and a C reader for it."""
    def mark(i):
        return (f"    if (blockIdx.x == 0 && threadIdx.x == 0) {{ long long n_ = clock64(); "
                f"k4_clk[{i}] += n_ - t_; t_ = n_; }}\n")

    src = _replace(src, "namespace mdcv {\n",
                   "namespace mdcv {\n__device__ unsigned long long k4_clk[8];\n")
    src = _replace(src, "  int buf = 0;\n", "  int buf = 0;\n  long long t_ = clock64();\n")
    for i, anchor in enumerate(ANCHORS):
        head, tail = anchor.split("\n", 1)
        src = _replace(src, anchor, f"{head}\n{mark(i)}{tail}")
    src = _replace(src, LOOP_END, mark(4) + LOOP_END)
    return src + ('extern "C" int k4_clk_read(void* host) {\n'
                  '  return int(cudaMemcpyFromSymbol(host, mdcv::k4_clk, 64)); }\n'
                  'extern "C" int k4_clk_reset() { unsigned long long z[8] = {};\n'
                  '  return int(cudaMemcpyToSymbol(mdcv::k4_clk, z, 64)); }\n')


def without_epilogue(src: str) -> str:
    src = _replace(src, Q8_BODY, "  return static_cast<int8_t>(__float_as_int(v));")
    return _replace(src, DEQ_BODY, "  return __ushort_as_bfloat16(static_cast<unsigned short>(acc));")


def build(variants: dict) -> dict:
    out = _lib.BUILD / "k4_phases"
    out.mkdir(parents=True, exist_ok=True)
    flags = list(_lib.NVCC_FLAGS)
    procs = {}
    for name, text in variants.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_lib._nvcc(), *flags, "-I", str(_lib.CSRC), "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "Used" in line or "spill" in line]
        print(f"{name}: {' | '.join(regs[:2])}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
        fn = libs[name].mdcv_entry_block
        fn.argtypes = list(_lib.SIGNATURES["mdcv_entry_block"])
        fn.restype = ctypes.c_int
    return libs


def main() -> int:
    smi = cs.phase_device()
    dev = torch.device("cuda:0")
    src = (_lib.CSRC / "entry_block.cu").read_text()
    libs = build({"kernel": src, "cycles": with_cycles(src),
                  "no_epilogue": with_cycles(without_epilogue(src))})
    g = torch.Generator().manual_seed(0)

    def conv(o, i, k):
        return {"w": torch.randn(o, i, k, k, generator=g) * 0.1,
                "b": torch.randn(o, generator=g) * 0.1}

    ep = entry.quantize_entry({"0": conv(32, 3, 3), "1": conv(64, 32, 3), "2": conv(32, 64, 1),
                               "3": conv(64, 32, 3)},
                              {"0": 1.0, "1": 3.0, "2": 2.0, "3": 2.5, "5": 4.0})
    ep = {k: v.to(dev) for k, v in entry.pack_entry(ep).items()}
    frames = torch.rand((cs.B_SERVE, cs.SIZE, cs.SIZE, 3), generator=g).to(dev, torch.bfloat16)
    hq = entry.conv1_4x4_q8(frames, ep, cs.SLOPE)
    ref = entry._entry_rest(hq, ep, cs.SLOPE)
    slope = float(torch.tensor(cs.SLOPE, dtype=torch.bfloat16))
    B, H, W, _ = hq.shape

    def runner(name):
        out = torch.empty_like(ref)
        fn = libs[name].mdcv_entry_block

        def call():
            rc = fn(hq.data_ptr(), ep["w2_tc"].data_ptr(), ep["w2_scale"].data_ptr(),
                    ep["w2_b"].data_ptr(), ep["w1x1_tc"].data_ptr(), ep["w1x1_scale"].data_ptr(),
                    ep["w1x1_b"].data_ptr(), ep["w3_tc"].data_ptr(), ep["w3_scale"].data_ptr(),
                    ep["w3_b"].data_ptr(), ep["sx"].data_ptr(), out.data_ptr(), B, H, W, slope,
                    _lib.DTYPE_CODES["int8"], torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return call, out

    kernel, out = runner("kernel")
    kernel()
    torch.cuda.synchronize()
    print(f"kernel equal to _entry_rest: {torch.equal(out, ref)}", flush=True)
    no_epi, _ = runner("no_epilogue")
    t = {"kernel": [], "no_epilogue": []}
    for name, fn in (("kernel", kernel), ("no_epilogue", no_epi), ("no_epilogue", no_epi),
                     ("kernel", kernel)):
        t[name].append(cs.cuda_ms(fn))
    for name in ("cycles", "no_epilogue"):
        clk = (ctypes.c_ulonglong * 8)()
        libs[name].k4_clk_reset()
        runner(name)[0]()
        torch.cuda.synchronize()
        libs[name].k4_clk_read(clk)
        c = list(clk)[:5]
        total = sum(c)
        print(f"{name}: block 0 cycles {dict(zip(PHASES, c))}, total {total}, shares "
              f"{ {k: round(v / total, 3) for k, v in zip(PHASES, c)} }", flush=True)
    print(f"ms at {tuple(hq.shape)}: kernel {t['kernel']}, no_epilogue {t['no_epilogue']} "
          f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
