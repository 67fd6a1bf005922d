"""Where the backward kernel of #1 spends its time: per-CTA timers between
its steps, on the card.

    python -m tdanet_tpu_torch.probes.dw_backward_phases [--out record.json]

Builds a copy of ``csrc/dw_conv_glob_ln_backward.cu`` whose PHASE_MARK
hooks (empty in the kernel that ships) read the global nanosecond timer
in thread 0 of every CTA and add the time since the previous mark to one
of 14 sums; only the bf16, T-innermost, K 5 stride-1 instances are built.
Each CTA's sums after one launch are printed as the mean and the largest
over the CTAs, µs, at the recipe's three finest K5 stride-1 sites (B 8).
A step's time is thread 0's view: where the warps run apart (T
innermost), a step also holds the time the other warps took the SM.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.kernels import dw_conv_glob_ln as dw
from tdanet_tpu_torch.probes.dw_backward import operands, recipe_scales
from tdanet_tpu_torch.probes.dw_sites import C
from tdanet_tpu_torch.utils.timing import card_line, graph_time

STEPS = ("phase 1: wait for the tile", "phase 1: ring load",
         "phase 1: new sample or channel tile", "phase 1: arithmetic",
         "phase 1: tail", "grid barrier 1", "phase 2: wait for the tile",
         "phase 2: new sample or channel tile", "phase 2: dz",
         "phase 2: halo, dx", "phase 2: store", "phase 2: tail",
         "grid barrier 2", "phase 3")
MARKS = """#define PHASE_MARK(n)                                                  \\
  if (threadIdx.x == 0) {                                              \\
    unsigned long long t_;                                             \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));             \\
    phase_ns[n] += t_ - phase_last;                                    \\
    phase_last = t_;                                                   \\
  }
#define PHASE_MARKS_BEGIN                                              \\
  unsigned long long phase_ns[14] = {}, phase_last = 0;                \\
  if (threadIdx.x == 0)                                                \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(phase_last));
#define PHASE_MARKS_END                                                \\
  if (threadIdx.x == 0)                                                \\
    for (int i_ = 0; i_ < 14; ++i_)                                    \\
      phase_sums[blockIdx.x * 14 + i_] = phase_ns[i_];
__device__ unsigned long long phase_sums[1024 * 14];
"""
READER = """
extern "C" int phase_read(unsigned long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, phase_sums, sizeof(phase_sums)));
}
"""


def timed_source():
    """The kernel's source with the marks defined and a reader of their
    sums, its instances cut to bf16, T innermost, K 5, stride 1."""
    src = (_build.CSRC / "dw_conv_glob_ln_backward.cu").read_text()
    edits = [("namespace {\n", MARKS + "namespace {\n")]
    edits += [(f"    case {k}: return make<TX, {k}, S, TC, RW>();\n", "")
              for k in (1, 3, 7)]
    edits.append((
        "  return x_bf16 ? pick_s<__nv_bfloat16>(K, stride, t_contig, rows)\n"
        "                : pick_s<float>(K, stride, t_contig, rows);",
        "  return x_bf16 && stride == 1 && t_contig\n"
        "             ? pick_s<__nv_bfloat16>(K, stride, t_contig, rows)\n"
        "             : Pick{nullptr, 0, 0, 0, 0};"))
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"the kernel's source has no {old!r}")
        src = src.replace(old, new, 1)
    return src + READER


def build():
    """Compile the timed copy under the build directory and load it."""
    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "k.cu").write_text(timed_source())
    so = out / "libphases.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(so), str(out / "k.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe runs on a GPU")
    lib = build()
    lib.phase_read.argtypes = [ctypes.c_void_p]
    for cached in (dw._backward_library, dw.backward_capacity,
                   dw.backward_plan):
        cached.cache_clear()
    loaded = _build.load
    _build.load = (lambda name: lib if name == "dw_conv_glob_ln_backward"
                   else loaded(name))
    dw._backward_library()  # sets the signatures on the timed copy
    gen = torch.Generator().manual_seed(0)
    record = {"card": card_line(), "steps": STEPS, "sites": []}
    print(card_line())
    for T in recipe_scales()[:3]:
        x, w, b, g, be, dy = operands(8, T, 5, 1, True, gen, torch.bfloat16)
        with torch.no_grad():
            _, stats = dw.forward_with_stats(x, w, b, g, be, stride=1, K=5)
            call = (lambda: dw.dw_conv_glob_ln_backward(
                dy, x, w, b, g, stats, stride=1, K=5))
            ms = graph_time(call, reps=20)[0]
            call()
            torch.cuda.synchronize()
        sums = (ctypes.c_ulonglong * (1024 * 14))()
        if lib.phase_read(sums) != 0:
            raise RuntimeError("reading the timers failed")
        grid = dw.backward_plan(1, 5, 1, True, dw.backward_rows(T, 1, True),
                                8, T, C, 0).grid
        per = [[sums[j * 14 + i] / 1e3 for i in range(14)]
               for j in range(grid)]
        mean = [sum(r[i] for r in per) / grid for i in range(14)]
        top = [max(r[i] for r in per) for i in range(14)]
        print(f"B=8 T={T} K5 s1 bf16: {ms * 1e3:.1f} us replayed; per CTA "
              f"(mean / largest of {grid}), us:")
        for name, a, m in zip(STEPS, mean, top):
            print(f"  {name:38s} {a:8.1f} / {m:8.1f}")
        record["sites"].append(dict(T=T, us=ms * 1e3, mean=mean, top=top))
    _build.load = loaded
    for cached in (dw._backward_library, dw.backward_capacity,
                   dw.backward_plan):
        cached.cache_clear()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.exit(main() and 0)
