// Kernel fp8_gemm: per-row dynamic fp8 quantization, then an fp8 GEMM.
//
// Replaces the Pallas kernel repro/kernels/fp8_gemm/kernel.py
// (_gemm_kernel / fp8_gemm_pallas).  For each of E independent products:
//   x (M, K) bf16, wq (K, N) e4m3, sw (N) f32  ->  out (M, N) bf16
//   sx[m]   = max(amax_k |x[m, k]|, 1e-12) / 448
//   xq[m,k] = e4m3(clip(x[m, k] / sx[m], -448, 448))      (round to nearest)
//   out     = bf16((sum_k xq[m, k] * wq[k, n]) * sx[m] * sw[n])   f32 sum
// The quantization is bit-identical to repro.core.quant.cast_to_fp8: a true
// IEEE division (never a reciprocal multiply), the clip, then the
// saturating round-to-nearest conversion.
//
// What bounds it on the H100: at a decode step (M = 32 rows) it must read
// the whole fp8 weight once, so it is bound by bytes (K*N bytes over
// 3.35 TB/s); at a prefill (M ~ 12k rows) by operations (2*M*N*K over the
// fp8 tensor-core peak of 1979 TFLOP/s).  Design (fp8_mma.cuh): the rows
// are quantized once per call (one warp per row), then one block per 64 x
// 64 output tile walks K in 128-deep chunks of e4m3 mma.sync on the tensor
// cores, each chunk's partial added to an f32 accumulator, and the sx * sw
// epilogue.  Loads are not overlapped with the products (no cp.async/TMA
// pipeline), and a decode-shape product launches only N/64 blocks: wgmma,
// TMA and split-K are the later steps.

#include "fp8_mma.cuh"

namespace {

using namespace fp8mma;

__global__ void __launch_bounds__(THREADS)
fp8_gemm_kernel(const uint8_t* __restrict__ xq,
                const uint8_t* __restrict__ w,
                const float* __restrict__ sw, const float* __restrict__ sx,
                __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  xq += (size_t)e * M * K;
  w += (size_t)e * K * N;
  sw += (size_t)e * N;
  sx += (size_t)e * M;
  out += (size_t)e * M * N;

  __shared__ Smem s;
  load_scales(s, sx, M, m0, 1, 0);

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a(s, xq, M, K, m0, k0);
    load_b(s, w, K, N, k0, n0);
    __syncthreads();
    mma_chunk(s, part);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], part[mt][nt][i]);
    __syncthreads();
  }

  // epilogue: (acc * sx[row]) * sw[col], rounded once to bf16
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 32 + mt * 16 + g + (i >= 2 ? 8 : 0);
        const int m = m0 + r, n = n0 + wn * 32 + nt * 8 + 2 * t + (i & 1);
        if (m < M && n < N)
          out[(size_t)m * N + n] = __float2bfloat16_rn(
              __fmul_rn(__fmul_rn(acc[mt][nt][i], s.sx[r]), sw[n]));
      }
}

}  // namespace

// x (E, M, K) bf16, w (E, K, N) e4m3 bytes, sw (E, N) f32, out (E, M, N)
// bf16; scratch xq (E, M, K) bytes and sx (E, M) f32; all contiguous.
// Returns cudaGetLastError() after the launches.
extern "C" int fp8_gemm_launch(const void* x, const void* w, const void* sw,
                               void* out, void* xq, void* sx, int E, int M,
                               int N, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int code = quantize_groups(x, xq, sx, (long)E * M, K, K, st);
  if (code != 0) return code;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  fp8_gemm_kernel<<<grid, THREADS, 0, st>>>(
      (const uint8_t*)xq, (const uint8_t*)w, (const float*)sw,
      (const float*)sx, (__nv_bfloat16*)out, M, N, K);
  return (int)cudaGetLastError();
}
