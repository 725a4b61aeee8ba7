// Kernel batch_attention: GQA attention of a batch of query rows over a
// dense per-row KV cache, the decode attention of the contiguous slot-pool
// layout under use_attention_kernel.
//
// Replaces the Pallas kernel repro/kernels/batch_attention/kernel.py
// (_attn_kernel / batch_attention_pallas).  One block per (KV head, batch
// row, block of at most 16 query rows), one thread per head dimension.  A
// block's rows are r = t * G + g (query position t, head g of the group),
// read straight from q's (B, T, H, hd) layout and written to out's
// (B, T, H * hd); the block loads its rows' q_pos itself.  It walks the
// cache in tiles of 32 positions; for each tile it
//   * stages the bf16 K/V tile of its KV head in shared memory (as f32) with
//     the tile's k_pos,
//   * scores every (row, key) pair in f32 times `scale`, masking a key
//     unless 0 <= k_pos <= q_pos (and q_pos - k_pos < window when a window
//     is set); masked scores are -2e38,
//   * folds the tile into the online softmax (m, l in shared memory, the
//     f32 accumulator in registers), with p rounded to bf16 for the PV
//     product as the Pallas kernel rounds it to V's dtype,
// and finally writes acc / max(l, 1e-20), or 0 for a row with no valid key,
// as bf16.  Where the Pallas grid carried (m, l, acc) across sequential
// S-blocks in VMEM scratch, the loop over tiles runs inside the block.
//
// What bounds it on the H100: bytes.  A decode step reads the whole cache
// (at full width 32 x 388 positions x 4 KV heads x 128 x 2 B for K and V,
// 25 MB, ~7.6 us at 3.35 TB/s) and does ~4 operations per byte.  This first
// version reads each K/V byte once per block and keeps the softmax state on
// chip, but does not overlap a tile's load with the previous tile's math
// (cp.async or TMA double buffering), which is the later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 16;
constexpr int TILE = 32;
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void batch_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, __nv_bfloat16* __restrict__ out, int T,
    int H, int Kv, int S, int hd, float scale, int window) {
  const int kvh = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int G = H / Kv;
  const int r0 = blockIdx.z * MAX_ROWS;
  const int nr = min(MAX_ROWS, G * T - r0);
  extern __shared__ float smem[];
  float* Ks = smem;                          // TILE x (hd + 1)
  float* Vs = Ks + TILE * (hd + 1);          // TILE x hd
  float* Qs = Vs + TILE * hd;                // nr x hd
  float* Sc = Qs + MAX_ROWS * hd;            // nr x TILE scores, then p
  float* Mr = Sc + MAX_ROWS * TILE;          // running max
  float* Lr = Mr + MAX_ROWS;                 // running sum
  float* Al = Lr + MAX_ROWS;                 // rescale of this tile
  int* Kp = (int*)(Al + MAX_ROWS);           // TILE key positions
  int* Qp = Kp + TILE;                       // nr query positions
  unsigned char* Ok = (unsigned char*)(Qp + MAX_ROWS);  // nr x TILE valid

  // q row r (t_q = r / G, g = r % G) is head kvh * G + g at position t_q
  for (int i = t; i < nr * hd; i += blockDim.x) {
    const int r = r0 + i / hd, d = i % hd;
    const int tq = r / G, head = kvh * G + r % G;
    Qs[i] = __bfloat162float(q[(((size_t)b * T + tq) * H + head) * hd + d]);
  }
  if (t < nr) {
    Qp[t] = q_pos[(size_t)b * T + (r0 + t) / G];
    Mr[t] = NEG_INF;
    Lr[t] = 0.0f;
  }
  float acc[MAX_ROWS];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.0f;
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += TILE) {
    for (int i = t; i < TILE * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd, s = s0 + j;
      float kf = 0.0f, vf = 0.0f;
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * Kv + kvh) * hd + d;
        kf = __bfloat162float(k[off]);
        vf = __bfloat162float(v[off]);
      }
      Ks[j * (hd + 1) + d] = kf;
      Vs[j * hd + d] = vf;
    }
    for (int j = t; j < TILE; j += blockDim.x)
      Kp[j] = s0 + j < S ? k_pos[(size_t)b * S + s0 + j] : -1;
    __syncthreads();

    for (int i = t; i < nr * TILE; i += blockDim.x) {
      const int r = i / TILE, j = i % TILE;
      float s = 0.0f;
      for (int d = 0; d < hd; ++d)
        s = fmaf(Qs[r * hd + d], Ks[j * (hd + 1) + d], s);
      const int kp = Kp[j], qp = Qp[r];
      const bool ok = kp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
      Sc[i] = ok ? s * scale : NEG_INF;
      Ok[i] = ok;
    }
    __syncthreads();

    if (t < nr) {
      const float m_old = Mr[t];
      float m_new = m_old;
      for (int j = 0; j < TILE; ++j) m_new = fmaxf(m_new, Sc[t * TILE + j]);
      float sum = 0.0f;
      for (int j = 0; j < TILE; ++j) {
        const float e = Ok[t * TILE + j] ? expf(Sc[t * TILE + j] - m_new) : 0.0f;
        Sc[t * TILE + j] = e;
        sum += e;
      }
      const float alpha = expf(m_old - m_new);
      Lr[t] = Lr[t] * alpha + sum;
      Mr[t] = m_new;
      Al[t] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < nr) {
        float pv = 0.0f;
        for (int j = 0; j < TILE; ++j)
          pv = fmaf(bf16_round(Sc[r * TILE + j]), Vs[j * hd + t], pv);
        acc[r] = acc[r] * Al[r] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (r < nr) {
      const int tq = (r0 + r) / G, head = kvh * G + (r0 + r) % G;
      const float l = Lr[r];
      const float o = l > 0.0f ? acc[r] / fmaxf(l, 1e-20f) : 0.0f;
      out[(((size_t)b * T + tq) * H + head) * hd + t] = __float2bfloat16_rn(o);
    }
  }
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)TILE * (hd + 1) + (size_t)TILE * hd +
                          (size_t)MAX_ROWS * hd + (size_t)MAX_ROWS * TILE +
                          3 * MAX_ROWS) +
         sizeof(int) * (TILE + MAX_ROWS) + (size_t)MAX_ROWS * TILE;
}

}  // namespace

// q (B, T, H, hd) bf16; k/v (B, S, Kv, hd) bf16; q_pos (B, T) i32; k_pos
// (B, S) i32; out (B, T, H, hd) bf16; all contiguous.  blockDim = hd (a
// multiple of 32, at most 1024); H a multiple of Kv.
// Returns cudaGetLastError() after the launch.
extern "C" int batch_attention_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* k_pos, void* out, int B,
                                      int T, int H, int Kv, int S, int hd,
                                      float scale, int window, void* stream) {
  if (hd % 32 || hd > 1024 || Kv < 1 || H % Kv) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const size_t smem = smem_bytes(hd);
  const int row_blocks = ((H / Kv) * T + MAX_ROWS - 1) / MAX_ROWS;
  dim3 grid(Kv, B, row_blocks);
  cudaFuncSetAttribute(batch_attention_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  batch_attention_kernel<<<grid, hd, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)q_pos, (const int*)k_pos,
      (__nv_bfloat16*)out, T, H, Kv, S, hd, scale, window);
  return (int)cudaGetLastError();
}
