// Kernel radix_topk: row-wise top-k by radix select, the serving engine's
// select under use_radix_topk.
//
// Replaces the Pallas kernels repro/kernels/radix_topk/kernel.py
// (_hist_kernel / hist_round_pallas and _emit_kernel / emit_pallas) and
// their orchestration in repro/kernels/radix_topk/ops.py (_threshold_scan,
// _radix_topk): the two Pallas kernels and the four-round loop between
// them are one kernel here.  One block of 1024 threads per row; the TPU
// version's sequential (row-block, column-block) grid becomes a loop over
// the row inside the block.
//   * Key: the order-preserving map f32 -> u32 (negatives flip every bit,
//     the rest set the sign bit), computed from x as it is read.  Columns
//     past V up to the JAX wrapper's padded length Vp read as `pad`
//     (float32 min cast to x's dtype).
//   * Four byte rounds (bits 31..24 down to 7..0): a 256-bin shared-memory
//     histogram (atomicAdd) of the byte of every key whose higher bytes
//     match the prefix found so far, then one warp's suffix scan finds the
//     largest byte t whose count-from-the-top reaches `need`, appends t to
//     the prefix and keeps need - (keys above t) (_threshold_scan).  After
//     the last round the prefix is the k-th key u* and `need` the number of
//     ties at u* still to take.
//   * Emission walks the row in index order, one tile of 1024 columns at a
//     time: ballots and popcounts give each tie its rank and each selected
//     column its output slot (everything above u*, plus the first `need`
//     ties by index), as _emit_kernel's running counts do.  A selected -0.0
//     is written as +0.0, as the Pallas one-hot sum writes it.
//   * The k outputs are sorted in shared memory by (value desc, index asc),
//     the JAX wrapper's stable argsort of -values.
//
// What bounds it on the H100: bytes, and at the engine's shapes (32 rows of
// 8256 f32) launch latency: the row is read five times, from L2 after the
// first, so the work per launch is a few microseconds of latency-bound
// loops.  This first version keeps the row out of shared memory (it re-reads
// it from L2 each round) and launches one block per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = THREADS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_value(const void* x, size_t row_off,
                                            int i, int V, int bf16,
                                            float pad) {
  if (i >= V) return pad;
  if (bf16) return __bfloat162float(((const __nv_bfloat16*)x)[row_off + i]);
  return ((const float*)x)[row_off + i];
}

__device__ __forceinline__ uint32_t monotone_u32(float f) {
  const uint32_t bits = __float_as_uint(f);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

// Block-wide exclusive prefix count of `flag` in thread order; `*total` is
// the block's count.  Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_count(bool flag, int* buf,
                                                     int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(FULL, flag);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) buf[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = buf[lane];
    for (int off = 1; off < WARPS; off <<= 1) {
      const int n = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += n;
    }
    buf[WARPS + lane] = v;                   // inclusive sums per warp
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : buf[WARPS + warp - 1];
  *total = buf[2 * WARPS - 1];
  __syncthreads();                           // buf is reused by the caller
  return before + in_warp;
}

__global__ void __launch_bounds__(THREADS)
radix_topk_kernel(const void* __restrict__ x, float* __restrict__ vals,
                  int* __restrict__ idx, int V, int Vp, int k, int bf16,
                  float pad) {
  __shared__ int hist[256];
  __shared__ int buf[2 * WARPS];
  __shared__ uint32_t s_prefix;
  __shared__ int s_need;
  __shared__ float out_v[MAX_K];
  __shared__ int out_i[MAX_K];
  const int tid = threadIdx.x;
  const size_t row_off = (size_t)blockIdx.x * V;

  uint32_t prefix = 0;
  int need = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += THREADS) hist[i] = 0;
    __syncthreads();
    const uint32_t high = shift < 24 ? (0xFFFFFFFFu << (shift + 8)) : 0u;
    for (int i = tid; i < Vp; i += THREADS) {
      const uint32_t u = monotone_u32(load_value(x, row_off, i, V, bf16, pad));
      if ((u & high) == (prefix & high))
        atomicAdd(&hist[(u >> shift) & 255u], 1);
    }
    __syncthreads();
    if (tid < 32) {
      // lane L owns bins 8L .. 8L+7; C(t) = keys whose byte is >= t
      const int lane = tid;
      int own[8], lane_sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        own[j] = hist[lane * 8 + j];
        lane_sum += own[j];
      }
      int from_here = lane_sum;              // sum over lanes >= this one
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_down_sync(FULL, from_here, off);
        if (lane + off < 32) from_here += n;
      }
      int c = from_here - lane_sum, found = -1, c_found = 0;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        c += own[j];                         // C(8 * lane + j)
        if (found < 0 && c >= need) {
          found = j;
          c_found = c;
        }
      }
      // the largest t with C(t) >= need lies in the highest such lane;
      // one exists because need <= the keys matching the prefix
      const unsigned any = __ballot_sync(FULL, found >= 0);
      if (any != 0u && lane == 31 - __clz(any)) {
        s_prefix = prefix | ((uint32_t)(lane * 8 + found) << shift);
        s_need = need - (c_found - own[found]);
      }
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
  }

  // emission in index order: keys above u* = prefix, plus the first `need`
  // ties; exactly k columns are selected
  int ties_seen = 0, taken = 0;
  for (int base = 0; base < Vp && taken < k; base += THREADS) {
    const int i = base + tid;
    float f = 0.0f;
    uint32_t u = 0u;
    if (i < Vp) {
      f = load_value(x, row_off, i, V, bf16, pad);
      u = monotone_u32(f);
    }
    const bool in = i < Vp;
    const bool tie = in && u == prefix;
    int n_ties, n_sel;
    const int tie_rank = ties_seen + block_exclusive_count(tie, buf, &n_ties);
    const bool sel = (in && u > prefix) || (tie && tie_rank < need);
    const int slot = taken + block_exclusive_count(sel, buf, &n_sel);
    if (sel) {
      out_v[slot] = f == 0.0f ? 0.0f : f;
      out_i[slot] = i;
    }
    ties_seen += n_ties;
    taken += n_sel;
  }
  __syncthreads();

  // stable sort by value, descending: rank = outputs that precede this one
  for (int j = tid; j < k; j += THREADS) {
    const float vj = out_v[j];
    const int ij = out_i[j];
    int rank = 0;
    for (int m = 0; m < k; ++m) {
      const float vm = out_v[m];
      rank += (vm > vj) || (vm == vj && out_i[m] < ij);
    }
    vals[(size_t)blockIdx.x * k + rank] = vj;
    idx[(size_t)blockIdx.x * k + rank] = ij;
  }
}

}  // namespace

// x (B, V) f32 (bf16 == 0) or bf16, contiguous; vals (B, k) f32 and idx
// (B, k) i32 out.  Vp >= V is the padded row length, `pad` the pad
// columns' value.  Requires 1 <= k <= min(V, 1024).
// Returns cudaGetLastError() after the launch.
extern "C" int radix_topk_launch(const void* x, void* vals, void* idx, int B,
                                 int V, int Vp, int k, int bf16, float pad,
                                 void* stream) {
  if (k < 1 || k > MAX_K || k > V || Vp < V) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  radix_topk_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      x, (float*)vals, (int*)idx, V, Vp, k, bf16, pad);
  return (int)cudaGetLastError();
}
