// Shared machinery of the two fp8 GEMM kernels (fp8_gemm.cu,
// fp8_grouped_gemm.cu): e4m3 x e4m3 products on the tensor cores with
// mma.sync.m16n8k32, f32 accumulation.
//
// Each wrapper call launches two kernels.  quantize_groups_kernel casts the
// bf16 activations to e4m3 once, one warp per (row, group of G columns):
// the scale max(amax, 1e-12) / 448 per group (G = K for fp8_gemm's
// per-row scales, 128 for the grouped GEMM's 1 x 128 blocks), a true
// division by it, the clip and the saturating round-to-nearest conversion,
// bit-identical to repro.core.quant.cast_to_fp8.  Then the GEMM kernel
// computes 64 x 64 output tiles with 4 warps (2 x 2, 32 x 32 each),
// walking K in 128-deep chunks: it copies the chunk's e4m3 activation tile
// and, transposed (k contiguous per output column, the layout mma's B
// operand reads), its e4m3 weight tile into shared memory, and runs 4
// k-steps of mma into a per-chunk partial that the caller folds into its
// f32 accumulator (scaled, for block scales).  Folding every 128 deep also
// bounds what the tensor cores' own accumulation can lose.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fp8mma {

constexpr int BM = 64, BN = 64, BK = 128, THREADS = 128;
constexpr int LD = BK + 16;   // row stride in bytes: conflict-free fragments
constexpr float FP8_MAX = 448.0f;

struct __align__(16) Smem {
  uint8_t a[BM][LD];   // e4m3 activations, [row][k]
  uint8_t b[BN][LD];   // e4m3 weights, transposed: [col][k]
  float sx[BM];        // the rows' activation scales for the current chunk
};

__device__ __forceinline__ uint32_t quant_e4m3(float x, float s) {
  float y = __fdiv_rn(x, s);
  y = fminf(fmaxf(y, -FP8_MAX), FP8_MAX);
  return (uint32_t)__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
}

// x (R, K) bf16 -> xq (R, K) e4m3 bytes and sx (R, K / G) f32, one warp per
// (row, group of G columns); G divides K
__global__ void quantize_groups_kernel(const __nv_bfloat16* __restrict__ x,
                                       uint8_t* __restrict__ xq,
                                       float* __restrict__ sx, long R, int K,
                                       int G) {
  const int groups = K / G, lane = threadIdx.x % 32;
  const long gid = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (gid >= R * groups) return;
  const size_t off = (size_t)(gid / groups) * K + (size_t)(gid % groups) * G;
  float a = 0.0f;
  for (int k = lane; k < G; k += 32)
    a = fmaxf(a, fabsf(__bfloat162float(x[off + k])));
  for (int o = 16; o > 0; o /= 2)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  const float s = __fdiv_rn(fmaxf(a, 1e-12f), FP8_MAX);
  if (lane == 0) sx[gid] = s;
  for (int k = lane; k < G; k += 32)
    xq[off + k] = (uint8_t)quant_e4m3(__bfloat162float(x[off + k]), s);
}

inline int quantize_groups(const void* x, void* xq, void* sx, long R, int K,
                           int G, cudaStream_t stream) {
  const long warps = R * (K / G);
  quantize_groups_kernel<<<(unsigned)((warps + 3) / 4), 128, 0, stream>>>(
      (const __nv_bfloat16*)x, (uint8_t*)xq, (float*)sx, R, K, G);
  return (int)cudaGetLastError();
}

// s.sx[r] = sx[(m0 + r) * stride + col], 0 past the last row
__device__ __forceinline__ void load_scales(Smem& s,
                                            const float* __restrict__ sx,
                                            int M, int m0, int stride,
                                            int col) {
  for (int r = threadIdx.x; r < BM; r += THREADS)
    s.sx[r] = m0 + r < M ? sx[(size_t)(m0 + r) * stride + col] : 0.0f;
}

// xq[m0:m0+BM, k0:k0+BK] (row-major M x K e4m3 bytes) into s.a
__device__ __forceinline__ void load_a(Smem& s,
                                       const uint8_t* __restrict__ xq,
                                       int M, int K, int m0, int k0) {
  if (K % 16 == 0) {
    for (int i = threadIdx.x; i < BM * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const int m = m0 + r, k = k0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M && k < K)
        v = *reinterpret_cast<const uint4*>(xq + (size_t)m * K + k);
      *reinterpret_cast<uint4*>(&s.a[r][c]) = v;
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, m = m0 + r, k = k0 + c;
      s.a[r][c] = (m < M && k < K) ? xq[(size_t)m * K + k] : 0;
    }
  }
}

// w[k0:k0+BK, n0:n0+BN] (row-major K x N e4m3 bytes) into s.b transposed
__device__ __forceinline__ void load_b(Smem& s, const uint8_t* __restrict__ w,
                                       int K, int N, int k0, int n0) {
  if (N % 16 == 0) {
    for (int i = threadIdx.x; i < BK * (BN / 16); i += THREADS) {
      const int kk = i / (BN / 16), q = (i % (BN / 16)) * 16;
      const int k = k0 + kk, n = n0 + q;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < K && n < N)
        v = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        s.b[q + j][kk] = (uint8_t)(words[j / 4] >> (8 * (j % 4)));
    }
  } else {
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int kk = i / BN, q = i % BN, k = k0 + kk, n = n0 + q;
      s.b[q][kk] = (k < K && n < N) ? w[(size_t)k * N + n] : 0;
    }
  }
}

__device__ __forceinline__ void mma_e4m3(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// part[mt][nt][i] = this warp's 32 x 32 share of the chunk's product:
// rows wm*32 + mt*16 + g (+8 for i >= 2), cols wn*32 + nt*8 + 2t (+1)
__device__ __forceinline__ void mma_chunk(const Smem& s, float part[2][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 32) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm * 32 + mt * 16 + g;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(&s.a[r][ks + t * 4]);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(&s.a[r + 8][ks + t * 4]);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(&s.a[r][ks + 16 + t * 4]);
      a[mt][3] =
          *reinterpret_cast<const uint32_t*>(&s.a[r + 8][ks + 16 + t * 4]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = wn * 32 + nt * 8 + g;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(&s.b[n][ks + t * 4]);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(&s.b[n][ks + 16 + t * 4]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_e4m3(part[mt][nt], a[mt], b[nt]);
  }
}

}  // namespace fp8mma
