#!/usr/bin/env python3
"""Two questions about the card that the port's GEMM kernels lean on, on
one NVIDIA H100 (run from the repository root; needs ``nvcc``):

1. Does a ``wgmma`` output element depend on the instruction's width?
   The same A (from registers) and B (K-major, 128-byte-swizzled in
   shared memory) go through a chain of four m64nNk16 products for
   N = 64, 128 and 256, over many random trials whose values span
   many binades; the first 64 columns are compared bitwise. The int8
   matmul's batch invariance rests on every output element being the
   same chain of products at any M.
2. What does ``chip_smoke.time_ms`` charge a launch that streams almost
   nothing? Its median (256 MiB write to flush L2, a device sleep, CUDA
   events around the call) for an empty call, a one-element write, and
   the int8 kernel and cuBLAS at a decode shape, beside the same timings
   with a flush that only reads (so that L2 holds no dirty lines when
   the call starts).
3. How fast can two consumer warpgroups issue products from operands
   already in shared memory (no loads in the loop)? One block an SM,
   each warpgroup repeating a stage of four k16 products and a wait for
   them, as the int8 kernel's consumers do: RS m64n128k16 (the int8
   kernel's prefill shape) with and without widening its int8 fragments
   each stage, RS m64n256k16, and SS m64n128k16 / m64n256k16 (both
   operands K-major); TFLOP/s against the 989 of the data sheet.

    python3 tools/torch_wgmma_probe.py

Prints one JSON line per question.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SRC = r"""
#include "hopper.cuh"
using bf16 = __nv_bfloat16;

// one block (one warpgroup) a trial: A [64][64], B [256][64] (k
// contiguous), D [64][N] = A B^T in four k16 products
template <int N>
__global__ void __launch_bounds__(128) probe_rs(const bf16* A, const bf16* B,
                                                float* D) {
  extern __shared__ unsigned char raw[];
  unsigned char* tile = raw + ((1024 - hopper::smem_u32(raw) % 1024) % 1024);
  const int trial = blockIdx.x, tid = threadIdx.x;
  const bf16* a = A + size_t(trial) * 64 * 64;
  const bf16* b = B + size_t(trial) * 256 * 64;
  for (int i = tid; i < N * 8; i += 128) {
    const int r = i / 8, c = i % 8;
    *reinterpret_cast<uint4*>(tile + r * 128 + ((c ^ (r % 8)) * 16)) =
        *reinterpret_cast<const uint4*>(b + r * 64 + c * 8);
  }
  hopper::fence_async_smem();
  __syncthreads();
  const int w = tid / 32, g = tid % 32 / 4, t = tid % 4;
  uint32_t fr[4][4];
  for (int kk = 0; kk < 4; ++kk)
    for (int h = 0; h < 4; ++h) {
      const int row = 16 * w + g + 8 * (h % 2), col = 16 * kk + 2 * t + 8 * (h / 2);
      __nv_bfloat162 v;
      v.x = a[row * 64 + col];
      v.y = a[row * 64 + col + 1];
      fr[kk][h] = *reinterpret_cast<uint32_t*>(&v);
    }
  float acc[N / 2];
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_rs<N, 0>(acc, fr[kk],
                             hopper::desc_sw128(hopper::smem_u32(tile) + kk * 32),
                             kk > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait();
  hopper::fence_regs(acc);
  float* d = D + size_t(trial) * 64 * N;
  for (int j = 0; j < N / 8; ++j)
    for (int q = 0; q < 4; ++q)
      d[(16 * w + g + 8 * (q / 2)) * N + 8 * j + 2 * t + q % 2] = acc[4 * j + q];
}

// bf16 pairs (q[k][c], q[k + 1][c]) for the even and the odd column of r's
// bytes, as int8_matmul.cu widens them
__device__ __forceinline__ void widen2(uint32_t r, uint32_t& even,
                                       uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  float f[4];
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
           8388736.f;
  even = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  odd = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

// two warpgroups, each `reps` stages of four k16 products of width N and
// a wait; RS: A from registers (widened from an int8 tile each stage with
// WIDEN), else SS; operands fixed in shared memory
template <int N, bool RS, bool WIDEN>
__global__ void __launch_bounds__(256) rate(int reps, float* sink) {
  extern __shared__ unsigned char raw[];
  unsigned char* xs = raw + ((1024 - hopper::smem_u32(raw) % 1024) % 1024);
  unsigned char* qs = xs + 256 * 128;
  for (int i = threadIdx.x; i < (256 * 128 + 64 * 128) / 4; i += 256)
    reinterpret_cast<uint32_t*>(xs)[i] = 0x3c003c00u ^ (i & 0x00ff00ffu);
  hopper::fence_async_smem();
  __syncthreads();
  const int lane = threadIdx.x % 32, chunk = threadIdx.x / 32;
  const uint32_t x = hopper::smem_u32(xs), q = hopper::smem_u32(qs);
  float acc[N / 2];
  uint32_t a[4][4];
  for (int kk = 0; kk < 4; ++kk)
    for (int h = 0; h < 4; ++h) a[kk][h] = 0x3c003c00u + threadIdx.x + h;
  for (int r = 0; r < reps; ++r) {
    if (WIDEN)
      for (int kb = 0; kb < 2; ++kb) {
        uint32_t v[4];
        hopper::ldsm_x4_t(v, q + (32 * kb + lane) * 128 +
                                 ((chunk ^ (lane % 8)) << 4));
        for (int i = 0; i < 4; ++i)
          widen2(v[i], a[2 * kb + i / 2][2 * (i % 2)],
                 a[2 * kb + i / 2][2 * (i % 2) + 1]);
      }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (RS)
        hopper::wgmma_rs<N, 0>(acc, a[kk], hopper::desc_sw128(x + kk * 32),
                               !(r == 0 && kk == 0));
      else
        hopper::wgmma_ss_t<N, 0, 0>(acc, hopper::desc_sw128(x + kk * 32),
                                    hopper::desc_sw128(x + kk * 32),
                                    !(r == 0 && kk == 0));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(a[kk]);
    hopper::fence_regs(acc);
  }
  if (acc[0] == 1234.5f) sink[threadIdx.x] = acc[1];
}

extern "C" int rate_run(int which, int blocks, int reps, void* sink) {
  const int smem = 256 * 128 + 64 * 128 + 1024;
  auto run = [&](auto kern) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kern<<<blocks, 256, smem>>>(reps, static_cast<float*>(sink));
  };
  switch (which) {
    case 0: run(rate<128, true, false>); break;
    case 1: run(rate<128, true, true>); break;
    case 2: run(rate<256, true, false>); break;
    case 3: run(rate<128, false, false>); break;
    case 4: run(rate<256, false, false>); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe(const void* A, const void* B, void* D, int n, int trials) {
  const int smem = 256 * 128 + 1024;
  auto run = [&](auto kern) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kern<<<trials, 128, smem>>>(static_cast<const bf16*>(A),
                                static_cast<const bf16*>(B),
                                static_cast<float*>(D));
  };
  if (n == 64) run(probe_rs<64>);
  else if (n == 128) run(probe_rs<128>);
  else if (n == 256) run(probe_rs<256>);
  else return -1;
  return static_cast<int>(cudaGetLastError());
}
"""


def build() -> ctypes.CDLL:
    from torch.utils.cpp_extension import CUDA_HOME
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "wgmma_probe.cu").write_text(SRC)
    lib = out / "wgmma_probe.so"
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(ROOT / "paddle_tpu_torch" / "csrc"),
                    "-o", str(lib), str(out / "wgmma_probe.cu")], check=True)
    so = ctypes.CDLL(str(lib))
    so.probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    so.probe.restype = ctypes.c_int
    so.rate_run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    so.rate_run.restype = ctypes.c_int
    return so


def width_question(trials: int = 4096) -> dict:
    so = build()
    rs = np.random.RandomState(0)

    def draw(shape):
        v = rs.randn(*shape) * np.exp2(rs.randint(-12, 13, shape))
        return torch.as_tensor(v, dtype=torch.float32).to(
            torch.bfloat16).cuda()

    A, B = draw((trials, 64, 64)), draw((trials, 256, 64))
    outs = {}
    for n in (64, 128, 256):
        D = torch.empty((trials, 64, n), dtype=torch.float32, device="cuda")
        assert so.probe(A.data_ptr(), B.data_ptr(), D.data_ptr(), n,
                        trials) == 0
        torch.cuda.synchronize()
        outs[n] = D
    ref = torch.einsum("tmk,tnk->tmn", A.double(), B.double()[:, :64])
    return {"question": "wgmma width", "trials": trials,
            "n128_equals_n64": bool(torch.equal(outs[128][..., :64],
                                                outs[64])),
            "n256_equals_n64": bool(torch.equal(outs[256][..., :64],
                                                outs[64])),
            "n256_cols_128_equal_n128": bool(torch.equal(
                outs[256][..., :128], outs[128])),
            "max_rel_err_n64": float(((outs[64].double() - ref).abs()
                                      / ref.abs().clamp(min=1e-30))
                                     .median())}


def timed(fn, flush_read: bool, reps: int = 20) -> float:
    """``chip_smoke.time_ms``, with the flush a read where asked."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush_read:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def floor_question() -> dict:
    import chip_smoke as cs
    from paddle_tpu_torch.ops.fused.int8_matmul import (
        quantize_weight_per_channel)
    from paddle_tpu_torch.ops.kernels.int8_matmul import int8_matmul
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.empty(1, device="cuda")
    cases = {"empty call": lambda: None, "one-element write": one.zero_}
    for name, (K, N) in (("tiny", (64, 128)),
                         ("wk_wv", cs.INT8_SHAPES["wk_wv"]),
                         ("wq_wo", cs.INT8_SHAPES["wq_wo"])):
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        q, s = quantize_weight_per_channel(w.to(torch.bfloat16))
        x = torch.randn((1, K), generator=gen, device="cuda").bfloat16()
        wb = (q.float() * s).bfloat16()
        cases[f"int8 {name} M=1"] = (lambda x=x, q=q, s=s:
                                     int8_matmul(x, q, s, "kernel"))
        cases[f"cuBLAS bf16 {name} M=1"] = lambda x=x, wb=wb: x @ wb
    out = {"question": "time_ms floor", "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi_line()}
    for name, fn in cases.items():
        out[name] = {"write_flush_ms": timed(fn, False),
                     "read_flush_ms": timed(fn, True),
                     "time_ms": cs.time_ms(fn)}
    return out


def rate_question(reps: int = 20000) -> dict:
    """TFLOP/s of question 3's loops over every SM (CUDA events around a
    warm launch)."""
    so = build()
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.empty(256, device="cuda")
    out = {"question": "consumer product rate", "reps": reps,
           "blocks": blocks}
    for which, name, n in ((0, "rs_n128", 128), (1, "rs_n128_widen", 128),
                           (2, "rs_n256", 256), (3, "ss_n128", 128),
                           (4, "ss_n256", 256)):
        assert so.rate_run(which, blocks, 10, sink.data_ptr()) == 0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        assert so.rate_run(which, blocks, reps, sink.data_ptr()) == 0
        b.record()
        b.synchronize()
        flops = blocks * 2 * reps * 4 * 2.0 * 64 * n * 16
        out[name] = flops / (a.elapsed_time(b) * 1e-3) / 1e12
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(width_question()), flush=True)
    print(json.dumps(floor_question()), flush=True)
    print(json.dumps(rate_question()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
