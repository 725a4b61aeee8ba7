// Kernel paged_decode: fused paged-decode attention over the paged KV pool.
//
// Replaces the Pallas kernel repro/kernels/paged_decode/kernel.py
// (_decode_kernel / paged_decode_pallas).  One block per (slot b, KV head
// h), one thread per head dimension.  The block loads its slot's page
// table itself and walks the table entries in order; for each entry it
//   * gathers the K/V page at physical page tables[b, p], dequantizing an
//     fp8 payload against its per-(position, head) f32 scale and rounding
//     to bf16 (repro.core.quant.dequantize_kv), into shared memory,
//   * scores the C*G query rows (r = c*G + g) against the page's keys in
//     f32, masking a key unless 0 <= pos <= length and (logical < start or
//     the key lies in row r's own span [start + c*stride, + stride)),
//   * folds the page into the online softmax (m, l in shared memory, the
//     f32 accumulator in registers), with p rounded to bf16 for the PV
//     product as the Pallas kernel does,
// and finally writes acc / l, or 0 for a row with no valid key.  Unmapped
// entries point at the sentinel page, whose pos is always -1.
//
// What bounds it on the H100: bytes.  Each step reads every mapped K/V
// position once (fp8: 2 * Kv * hd bytes per position, plus the scales) and
// does ~4 operations per byte, far below the card's ~590 operations per
// byte at fp8 rates.  This first version keeps each byte to one global
// read and the whole softmax state on chip; it does not overlap the next
// page's load with the current page's math (cp.async or TMA double
// buffering) and runs one block per (slot, head), which is the later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CG = 16;
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float e4m3_to_float(uint8_t v) {
  __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)v, __NV_E4M3);
  return __half2float(__half(h));
}

template <bool QUANT>
__global__ void paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kp,
    const void* __restrict__ vp, const int* __restrict__ pos,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    const int* __restrict__ starts, __nv_bfloat16* __restrict__ out, int Kv,
    int CG, int hd, int P, int ps, int group, int stride, float scale) {
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  extern __shared__ float smem[];
  float* Ks = smem;                      // ps x (hd + 1)
  float* Vs = Ks + ps * (hd + 1);        // ps x hd
  float* Qs = Vs + ps * hd;              // CG x hd
  float* S = Qs + CG * hd;               // CG x ps scores, then p
  float* Mr = S + CG * ps;               // CG running max
  float* Lr = Mr + CG;                   // CG running sum
  float* Al = Lr + CG;                   // CG rescale of this page
  int* Pv = (int*)(Al + CG);             // ps stored positions
  unsigned char* Ok = (unsigned char*)(Pv + ps);   // CG x ps valid flags

  const __nv_bfloat16* qb = q + (size_t)(b * Kv + h) * CG * hd;
  for (int i = t; i < CG * hd; i += blockDim.x) Qs[i] = __bfloat162float(qb[i]);
  if (t < CG) {
    Mr[t] = NEG_INF;
    Lr[t] = 0.0f;
  }
  float acc[MAX_CG];
#pragma unroll
  for (int r = 0; r < MAX_CG; ++r) acc[r] = 0.0f;
  const int length = lengths[b], start = starts[b];
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const size_t page = (size_t)tables[(size_t)b * P + p];
    for (int i = t; i < ps * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd;
      const size_t row = page * ps + j;
      const size_t off = (row * Kv + h) * hd + d;
      float kf, vf;
      if (QUANT) {
        kf = bf16_round(e4m3_to_float(((const uint8_t*)kp)[off]) *
                        ks[row * Kv + h]);
        vf = bf16_round(e4m3_to_float(((const uint8_t*)vp)[off]) *
                        vs[row * Kv + h]);
      } else {
        kf = __bfloat162float(((const __nv_bfloat16*)kp)[off]);
        vf = __bfloat162float(((const __nv_bfloat16*)vp)[off]);
      }
      Ks[j * (hd + 1) + d] = kf;
      Vs[j * hd + d] = vf;
    }
    for (int j = t; j < ps; j += blockDim.x) Pv[j] = pos[page * ps + j];
    __syncthreads();

    for (int i = t; i < CG * ps; i += blockDim.x) {
      const int r = i / ps, j = i % ps;
      float s = 0.0f;
      for (int d = 0; d < hd; ++d) s = fmaf(Qs[r * hd + d], Ks[j * (hd + 1) + d], s);
      const int logical = p * ps + j;
      const int own_lo = start + (r / group) * stride;
      const bool ok = Pv[j] >= 0 && Pv[j] <= length &&
                      (logical < start ||
                       (logical >= own_lo && logical < own_lo + stride));
      S[i] = ok ? s * scale : NEG_INF;
      Ok[i] = ok;
    }
    __syncthreads();

    if (t < CG) {
      const float m_old = Mr[t];
      float m_new = m_old;
      for (int j = 0; j < ps; ++j) m_new = fmaxf(m_new, S[t * ps + j]);
      float sum = 0.0f;
      for (int j = 0; j < ps; ++j) {
        const float e = Ok[t * ps + j] ? expf(S[t * ps + j] - m_new) : 0.0f;
        S[t * ps + j] = e;
        sum += e;
      }
      const float alpha = expf(m_old - m_new);
      Lr[t] = Lr[t] * alpha + sum;
      Mr[t] = m_new;
      Al[t] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < MAX_CG; ++r) {
      if (r < CG) {
        float pv = 0.0f;
        for (int j = 0; j < ps; ++j)
          pv = fmaf(bf16_round(S[r * ps + j]), Vs[j * hd + t], pv);
        acc[r] = acc[r] * Al[r] + pv;
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = out + (size_t)(b * Kv + h) * CG * hd;
#pragma unroll
  for (int r = 0; r < MAX_CG; ++r) {
    if (r < CG) {
      const float l = Lr[r];
      const float o = l > 0.0f ? acc[r] / fmaxf(l, 1e-20f) : 0.0f;
      ob[r * hd + t] = __float2bfloat16_rn(o);
    }
  }
}

size_t smem_bytes(int CG, int hd, int ps) {
  return sizeof(float) * ((size_t)ps * (hd + 1) + (size_t)ps * hd +
                          (size_t)CG * hd + (size_t)CG * ps + 3 * CG) +
         sizeof(int) * ps + (size_t)CG * ps;
}

}  // namespace

// q (B, Kv, CG, hd) bf16; k/v (NPos, Kv, hd) bf16 or e4m3 bytes (quantized
// != 0, then k_scale/v_scale (NPos, Kv) f32); pos (NPos) i32; tables (B, P)
// i32; lengths/starts (B) i32; out (B, Kv, CG, hd) bf16; all contiguous.
// blockDim = hd (a multiple of 32, at most 1024); CG <= 16.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pos,
                                   const void* k_scale, const void* v_scale,
                                   const void* tables, const void* lengths,
                                   const void* starts, void* out, int B,
                                   int Kv, int CG, int hd, int P, int ps,
                                   int group, int stride, float scale,
                                   int quantized, void* stream) {
  if (CG > MAX_CG || CG < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(CG, hd, ps);
  dim3 grid(Kv, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (quantized) {
    cudaFuncSetAttribute(paged_decode_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    paged_decode_kernel<true><<<grid, hd, smem, st>>>(
        (const __nv_bfloat16*)q, k, v, (const int*)pos,
        (const float*)k_scale, (const float*)v_scale, (const int*)tables,
        (const int*)lengths, (const int*)starts, (__nv_bfloat16*)out, Kv, CG,
        hd, P, ps, group, stride, scale);
  } else {
    cudaFuncSetAttribute(paged_decode_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    paged_decode_kernel<false><<<grid, hd, smem, st>>>(
        (const __nv_bfloat16*)q, k, v, (const int*)pos, nullptr, nullptr,
        (const int*)tables, (const int*)lengths, (const int*)starts,
        (__nv_bfloat16*)out, Kv, CG, hd, P, ps, group, stride, scale);
  }
  return (int)cudaGetLastError();
}
