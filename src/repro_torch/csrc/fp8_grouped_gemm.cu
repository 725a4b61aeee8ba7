// Kernel fp8_grouped_gemm: block-scaled fp8 grouped GEMM (the MoE experts).
//
// Replaces the Pallas kernel repro/kernels/fp8_grouped_gemm/kernel.py
// (_grouped_kernel / fp8_grouped_gemm_pallas).  Per expert e:
//   x (C, K) bf16, wq (K, N) e4m3, sw (K/128, N/128) f32 -> out (C, N) bf16
// For each 128-deep slice kb of K, the activation scale of row c is
//   sx[c, kb] = max(amax |x[c, kb*128 : kb*128+128]|, 1e-12) / 448
// (the 1 x 128 blocks), x is cast to e4m3 with it (true division, clip,
// round to nearest), and the slice's partial product is scaled and
// accumulated as the Pallas kernel does:
//   acc += (part[c, n] * sx[c, kb]) * sw[kb, n / 128]        f32
// Nothing is folded into bf16 operands.
//
// What bounds it on the H100: at a decode step (C = 8 rows per expert) the
// E*K*N weight bytes (3 products x 16 experts x 8 MiB per layer), so bytes
// over 3.35 TB/s; at a prefill (C ~ 3k) the 2*E*C*N*K operations over the
// fp8 tensor-core peak.  Design (fp8_mma.cuh): the 1 x 128 blocks are
// quantized once per call (one warp per block), then one block per
// (expert, 64-row, 64-column) tile, which never straddles a 128-column
// scale block, walks K in 128-deep slices of e4m3 mma.sync on the tensor
// cores and scales each slice's partial into the f32 accumulator (the
// DeepGEMM-style promotion every 128 deep).  Loads are not overlapped with
// the products: a TMA/wgmma pipeline is the later step.

#include "fp8_mma.cuh"

namespace {

using namespace fp8mma;

__global__ void __launch_bounds__(THREADS)
fp8_grouped_gemm_kernel(const uint8_t* __restrict__ xq,
                        const uint8_t* __restrict__ w,
                        const float* __restrict__ sw,
                        const float* __restrict__ sx,
                        __nv_bfloat16* __restrict__ out, int C, int N,
                        int K) {
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KB = K / BK, NB = N / BK, nb = n0 / BK;
  xq += (size_t)e * C * K;
  w += (size_t)e * K * N;
  sw += (size_t)e * KB * NB;
  sx += (size_t)e * C * KB;
  out += (size_t)e * C * N;

  __shared__ Smem s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, wm = warp / 2;
  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  for (int kb = 0; kb < KB; ++kb) {
    const int k0 = kb * BK;
    load_scales(s, sx, C, m0, KB, kb);
    load_a(s, xq, C, K, m0, k0);
    load_b(s, w, K, N, k0, n0);
    __syncthreads();
    mma_chunk(s, part);
    const float swb = sw[kb * NB + nb];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sxr = s.sx[wm * 32 + mt * 16 + g + (i >= 2 ? 8 : 0)];
          acc[mt][nt][i] = __fadd_rn(
              acc[mt][nt][i],
              __fmul_rn(__fmul_rn(part[mt][nt][i], sxr), swb));
        }
    __syncthreads();   // the next slice rewrites s
  }

  const int t = lane % 4, wn = warp % 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm * 32 + mt * 16 + g + (i >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + nt * 8 + 2 * t + (i & 1);
        if (m < C)
          out[(size_t)m * N + n] = __float2bfloat16_rn(acc[mt][nt][i]);
      }
}

}  // namespace

// x (E, C, K) bf16, w (E, K, N) e4m3 bytes, sw (E, K/128, N/128) f32,
// out (E, C, N) bf16; scratch xq (E, C, K) bytes and sx (E, C, K/128) f32;
// all contiguous, K and N multiples of 128.  Returns cudaGetLastError()
// after the launches.
extern "C" int fp8_grouped_gemm_launch(const void* x, const void* w,
                                       const void* sw, void* out, void* xq,
                                       void* sx, int E, int C, int N, int K,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int code = quantize_groups(x, xq, sx, (long)E * C, K, BK, st);
  if (code != 0) return code;
  dim3 grid(N / BN, (C + BM - 1) / BM, E);
  fp8_grouped_gemm_kernel<<<grid, THREADS, 0, st>>>(
      (const uint8_t*)xq, (const uint8_t*)w, (const float*)sw,
      (const float*)sx, (__nv_bfloat16*)out, C, N, K);
  return (int)cudaGetLastError();
}
