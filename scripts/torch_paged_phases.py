#!/usr/bin/env python3
"""Where the paged-attention kernel's time goes, phase by phase, on one
NVIDIA card.

    python3 scripts/torch_paged_phases.py [--reps N]

Neither ``ncu`` nor ``nsys`` is at hand, so this builds a copy of
``ops/csrc/paged_attention.cu`` with ``clock64()`` stamps at the
kernel's phase boundaries (thread 0 of the CUDA block of row 0, head 0),
into ``build/paged_phases/``, and runs it at the serving decode shape
(B=8 rows of 160 live tokens in a 16-wide table bucket, H=12, D=64,
bs=16, bf16 q) in each pool mode: the compute dtype, int8, int4 (g = 32)
and int4 with the residual lane.  Prints, per mode, the median SM cycles
of each phase over ``--reps`` launches (after a warm launch) and the
output's largest difference from the plain version, then the card's
``nvidia-smi`` line.  The stamps cost a few cycles each; the phases are
those of the source's design note.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mpi_tensorflow_torch.ops import _build  # noqa: E402
from mpi_tensorflow_torch.ops import paged_attention as ops  # noqa: E402
from mpi_tensorflow_torch.ops import paged_attention_kernel as pk  # noqa: E402

OUT = _build.BUILD_DIR.parent / "paged_phases"
STAMP = ("if (blockIdx.x + blockIdx.y + blockIdx.z == 0 && threadIdx.x == 0)"
         " g_t[{i}] = clock64();\n")
# (phase that ends at the stamp, the source text the stamp follows)
MARKS = [
    ("table, lengths, q",
     "      if (tid < nb) tbl[tid] = a.table[b * NB + j0 + tid];\n    }\n"
     "    __syncthreads();\n"),
    ("K copies", "    hopper::cp_async_wait<1>();\n    __syncthreads();\n"),
    ("scores", "                                      ncols, ncap, j0, len, "
               "s0, ginv);\n    __syncthreads();\n"),
    ("maxima, weights, V wait",
     "    hopper::cp_async_wait<0>();            // V\n    __syncthreads();\n"),
    ("p v", "      acc[k] = v;\n    }\n"),
    ("merge, store",
     "      out[tid] = from_float<T>(v / (l == 0.f ? 1.f : l));\n    }\n"),
]


def instrumented_source() -> str:
    src = (_build.CSRC / "paged_attention.cu").read_text()
    src = src.replace("namespace {\n", "__device__ long long g_t[16];\n"
                      "namespace {\n", 1)
    start = "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
    marks = [(None, start)] + MARKS
    for i, (_, text) in enumerate(marks):
        if text not in src:
            raise RuntimeError(f"the source changed: no marker {text!r}")
        src = src.replace(text, text + "  " + STAMP.format(i=i), 1)
    return src.replace('extern "C" {\n', 'extern "C" {\nint phase_clocks('
                       'void* dst) { return (int)cudaMemcpyFromSymbol(dst, '
                       'g_t, sizeof(g_t)); }\n', 1)


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "paged_phases.cu", OUT / "libpaged_phases.so"
    src.write_text(instrumented_source())
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_phases: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = build()
    fn = lib.paged_attention_fwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.phase_clocks.argtypes = [ctypes.c_void_p]
    B, H, S, D, BS, NB, live, group = 8, 12, 1, 64, 16, 16, 160, 32
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((B, H, S, D), generator=gen, device=dev).bfloat16()
    kp, vp = (torch.randn((1 + B * NB, H, BS, D), generator=gen,
                          device=dev).bfloat16() for _ in range(2))
    bt = torch.zeros((B, NB), dtype=torch.int32, device=dev)
    bt[:, :live // BS] = 1 + torch.randperm(
        B * NB, generator=gen, device=dev)[:B * live // BS].view(
            B, live // BS).to(torch.int32)
    lens = torch.full((B,), live - S, dtype=torch.int32, device=dev)
    names = [n for n, _ in MARKS]
    for mode in ("fp32", "int8", "int4", "int4_res"):
        kw, pools = {}, (kp, vp)
        if mode != "fp32":
            quant = (ops.quantize_kv if mode == "int8"
                     else lambda x: ops.quantize_kv_int4(x, group))
            (kc, ks), (vc, vs) = quant(kp), quant(vp)
            pools, kw = (kc, vc), {"k_scale": ks, "v_scale": vs}
        if mode == "int4_res":
            kw["k_new"], kw["v_new"] = (torch.randn(
                q.shape, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        G = kw["k_scale"].shape[-1] if mode.startswith("int4") else 1
        ptr = lambda t: 0 if t is None else t.data_ptr()
        out = torch.empty_like(q)
        clocks = []
        for rep in range(args.reps + 1):
            err = fn(1, pk.MODES[pk.pool_mode(kw.get("k_scale"))],
                     q.data_ptr(), pools[0].data_ptr(), pools[1].data_ptr(),
                     ptr(kw.get("k_scale")), ptr(kw.get("v_scale")),
                     ptr(kw.get("k_new")), ptr(kw.get("v_new")),
                     bt.data_ptr(), lens.data_ptr(), out.data_ptr(), B, H, S,
                     D, BS, NB, G, D ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError_t {err}")
            torch.cuda.synchronize()
            t = np.zeros(16, np.int64)
            lib.phase_clocks(t.ctypes.data)
            if rep:
                clocks.append(np.diff(t[:len(MARKS) + 1]))
        want = pk.paged_attention_reference(q, *pools, bt, lens, **kw)
        med = np.median(np.array(clocks), axis=0)
        print(f"{mode}: max|kernel - plain| "
              f"{float((out.float() - want.float()).abs().max()):.3e}; "
              f"median cycles " + ", ".join(
                  f"{n} {int(c)}" for n, c in zip(names, med))
              + f"; total {int(med.sum())}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
