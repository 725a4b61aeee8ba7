// Kernel fp8_gemm: per-row fp8 quantization (a dynamic scale per row, or
// one static calibrated scale), then an fp8 GEMM.
//
// Replaces the Pallas kernel repro/kernels/fp8_gemm/kernel.py
// (_gemm_kernel / fp8_gemm_pallas).  For each of E independent products:
//   x (M, K) bf16, wq (K, N) e4m3, sw (N) f32  ->  out (M, N) bf16
//   sx[m]   = max(amax_k |x[m, k]|, 1e-12) / 448           (dynamic), or
//   sx[m]   = s, the calibrated scale, for every row      (static)
//   xq[m,k] = e4m3(clip(x[m, k] / sx[m], -448, 448))      (round to nearest)
//   out     = bf16((sum_k xq[m, k] * wq[k, n]) * sx[m] * sw[n])   f32 sum
// The quantization is bit-identical to repro.core.quant.cast_to_fp8: a true
// IEEE division (never a reciprocal multiply), the clip, then the
// saturating round-to-nearest conversion.  The static mode reads its scale
// from device memory and skips the amax reduction; the GEMM is the same.
//
// What bounds it on the H100: at a decode step (M = 32 rows) it must read
// the whole fp8 weight once, so it is bound by bytes (K*N bytes over
// 3.35 TB/s); at a prefill (M ~ 12k rows) by operations (2*M*N*K over the
// tensor-core peak).  The design (sm90_fp8.cuh):
//
// * The sum is an f32 sum of exact products, as in the Pallas kernel: the
//   main loops run 16-bit wgmma (m64nNk16, f32 accumulation) on f16 copies
//   of the e4m3 values, which are exact (sm90_fp8.cuh, "16-bit operands").
//   e4m3 wgmma, whose accumulator keeps about 14 bits, put 6.5-6.7% of the
//   bf16 outputs off the correctly rounded result with a fold into f32
//   every 128 deep, and 2.5-2.7% with one every 32 (PERF.md, ROADMAP C2).
// * The weight is stored K-major: wq (K, N) is the transpose view of an
//   (N, K) row-major array (core.quant.quantize_per_channel lays it out so
//   once, at quantization), and its e4m3 tiles go from HBM to shared memory
//   by TMA as they are.  Each consumer thread converts its own A fragment
//   from the tile in registers (register-sourced A), so the weight's rows
//   are wgmma's M at every size: out^T = w^T . xq^T.
// * Quantization pass: one warp per row, 16-byte loads of 8 bf16 (element
//   loads for a row off a 16-byte boundary or K % 8 != 0), the amax
//   (dynamic mode), then the row cast to e4m3 and written as f16 in the
//   chunks' k order (sm90_fp8.cuh), rows padded with zeros to a multiple of
//   128: the B operand, which TMA copies to shared memory as it is.
// * Any K and N (the recsys towers' K = 180, 200, 270 and N = 1, 80, 200):
//   the weight's tensor map has dimension K at its padded row stride
//   (core.quant.k_major pads rows to 16 bytes), so TMA fills the boxes past
//   K, and past N, with zeros; the epilogues store only n < N and m < M.
// * Prefill (M >= 256): blocks of 128 weight rows x 128 activation rows, a
//   producer warpgroup (one thread) keeping a 4-stage ring of 128-deep
//   chunks in flight with TMA (16 KB of e4m3 weight, 32 KB of f16
//   activations), and two consumer warpgroups of 64 weight rows each:
//   8 x wgmma.m64n128k16 a chunk into one f32 accumulator, the next chunk's
//   A fragments loaded and converted while the last chunk's MMAs run
//   (setmaxnreg moves the producer's registers to the consumers).
// * Decode (M < 256): blocks of 64 weight rows x 32 activation rows; K is
//   split so that about one block per SM streams the weight.  Each split
//   writes an f32 partial; the last block of a tile to arrive (a counter)
//   adds the partials in split order, so the sum does not depend on which
//   block finishes first.  The epilogue scales by sx[m] * sw[n] and rounds
//   once to bf16.

#include "sm90_fp8.cuh"

namespace {

using namespace sm90;

// ---------------------------------------------------------------------------
// Quantization pass
// ---------------------------------------------------------------------------

constexpr int HELD = 8;   // 16-byte loads a lane keeps: rows up to 2048 wide

// the 8 bf16 of row `src` (K values) from element 8c, as one 16-byte
// vector: a 16-byte load when VEC (every row starts on a 16-byte boundary:
// x does and K % 8 == 0), else element by element, zeros past K (DIN's
// K = 180: a row every 360 bytes, 7 of 8 rows off the boundary).  VEC is
// a template parameter, so the aligned path compiles to the 16-byte loads
// alone: a run-time choice inside the loop slowed it (PERF.md, PR 20)
template <bool VEC>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ src,
                                       int c, int K) {
  if constexpr (VEC) {
    return reinterpret_cast<const uint4*>(src)[c];
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 8 * c + 2 * i;
      w[i] = (k < K ? (uint32_t)h[k] : 0u) |
             ((k + 1 < K ? (uint32_t)h[k + 1] : 0u) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// x (R, K) bf16 -> xh (R, Kp) f16 in the chunks' k order (Kp = K rounded
// up to 128, zeros past K) and sx (R) f32, one warp per row; any K >= 1
// and rows at any 2-byte boundary (load8<false>).  `fixed` null: the dynamic
// scale of each row; else *fixed for every row.  A row of up to 2048
// elements is read once and held in registers; a longer one is read twice
// (the second time from cache).  Also zeroes `counters` (n_counters ints)
// for the split-K reduction of the GEMM launched after it on the same
// stream.
template <bool VEC>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     uint32_t* __restrict__ xh, float* __restrict__ sx,
                     long R, int K, int Kp, const float* __restrict__ fixed,
                     int* __restrict__ counters, int n_counters) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n_counters;
       i += (long)gridDim.x * blockDim.x)
    counters[i] = 0;
  const int lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= R) return;
  const __nv_bfloat16* src = x + row * K;
  uint32_t* dst = xh + row * (Kp / 2);
  const int vecs = (K + 7) / 8;
  const bool held = vecs <= 32 * HELD;
  float s = fixed != nullptr ? *fixed : 0.0f;
  uint4 v[HELD];
  float a = 0.0f;
  if (held) {
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < vecs ? load8<VEC>(src, c, K) : make_uint4(0, 0, 0, 0);
      a = amax8(v[i], a);
    }
  } else if (fixed == nullptr) {
    for (int c = lane; c < vecs; c += 32)
      a = amax8(load8<VEC>(src, c, K), a);
  }
  if (fixed == nullptr) {
    for (int o = 16; o > 0; o /= 2)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    s = __fdiv_rn(fmaxf(a, 1e-12f), FP8_MAX);
  }
  if (lane == 0) sx[row] = s;
  if (held) {
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      const int c = lane + 32 * i;
      if (c < vecs) store_perm8(dst, c, quant8_f16(v[i], s));
    }
  } else {
    for (int c = lane; c < vecs; c += 32)
      store_perm8(dst, c, quant8_f16(load8<VEC>(src, c, K), s));
  }
  for (int c = vecs + lane; c < Kp / 8; c += 32)
    store_perm8(dst, c, make_uint4(0, 0, 0, 0));
}

// (acc * sx) * sw of output (m, n), rounded once to bf16 (OutT bf16) or
// kept in f32 (OutT float: the logits head's f32 output)
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

template <class OutT>
__device__ __forceinline__ void store_one(OutT* __restrict__ out, int e,
                                          int m, int n, int M, int N,
                                          float acc,
                                          const float* __restrict__ sx,
                                          float s_w) {
  put(out + ((size_t)e * M + m) * N + n,
      __fmul_rn(__fmul_rn(acc, sx[(size_t)e * M + m]), s_w));
}

// ---------------------------------------------------------------------------
// Prefill: TMA ring + two consumer warpgroups of m64n128k16
// ---------------------------------------------------------------------------

namespace pf {
constexpr int BN = 128;       // weight rows (output columns): 64 a consumer
constexpr int BM = 128;       // activation rows: wgmma's N
constexpr int STAGES = 4, CONSUMERS = 2;
// + a producer warpgroup (one thread issues the copies): registers are
// handed out per warpgroup, so it gives its share to the consumers
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int W_BYTES = BN * CHUNK;             // e4m3
constexpr int X_HALF = BM * CHUNK;              // f16, one 64-deep TMA box
constexpr int X_BYTES = 2 * X_HALF;
constexpr int SMEM = 1024 + STAGES * (W_BYTES + X_BYTES) + 2 * STAGES * 8;
}  // namespace pf

template <class OutT>
__global__ void __launch_bounds__(pf::THREADS, 1)
gemm_prefill_kernel(const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_x,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    OutT* __restrict__ out, int M, int N, int K) {
  using namespace pf;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sw8 = align1024(smem_raw);              // STAGES x (BN x 128) e4m3
  uint8_t* sxh = sw8 + STAGES * W_BYTES;           // STAGES x (BM x 128) f16
  uint64_t* full = reinterpret_cast<uint64_t*>(sxh + STAGES * X_BYTES);
  uint64_t* empty = full + STAGES;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const int chunks = (K + CHUNK - 1) / CHUNK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);          // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {                      // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      prefetch_map(&map_w);
      prefetch_map(&map_x);
      for (int c = 0; c < chunks; ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) mbar_wait(&empty[s], (c / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], W_BYTES + X_BYTES);
        tma_load(sw8 + s * W_BYTES, &map_w, &full[s], c * CHUNK, n0, e);
        uint8_t* xs = sxh + s * X_BYTES;
        tma_load(xs, &map_x, &full[s], c * CHUNK, m0, e);
        tma_load(xs + X_HALF, &map_x, &full[s], c * CHUNK + CHUNK / 2, m0,
                 e);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  // consumer warpgroup wg: weight rows 64 wg .. 64 wg + 63 of the tile;
  // this thread's A rows are arow and arow + 8
  const int wg = warp / 4, q = lane % 4;
  const int arow = 64 * wg + 16 * (warp % 4) + lane / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  uint32_t ra[32], rb[32];
  auto load = [&](int c, uint32_t(&a)[32]) {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    load_a_chunk(sw8 + s * W_BYTES, arow, q, a);
  };
  auto issue = [&](int c, uint32_t(&a)[32]) {
    const uint8_t* xs = sxh + (c % STAGES) * X_BYTES;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < CHUNK / 16; ++k)
      wgmma_f16_m64n128k16(acc, a + 4 * k, desc_f16_step(xs, BM, k), 1);
    wgmma_commit();
  };
  auto release = [&](int c, uint32_t(&a)[32]) {  // chunk c's MMAs are done
    fence_regs(a);
    if (lane == 0) mbar_arrive(&empty[c % STAGES]);
  };
  // chunk c + 1's fragments are loaded and converted while chunk c's MMAs
  // run; every chunk accumulates into acc, in chunk order
  load(0, ra);
  issue(0, ra);
  int c = 1;
  for (; c + 1 < chunks; c += 2) {
    load(c, rb);
    issue(c, rb);
    wgmma_wait<1>();
    release(c - 1, ra);
    load(c + 1, ra);
    issue(c + 1, ra);
    wgmma_wait<1>();
    release(c, rb);
  }
  if (c < chunks) {
    load(c, rb);
    issue(c, rb);
    wgmma_wait<1>();
    release(c - 1, ra);
    wgmma_wait<0>();
    release(c, rb);
  } else {
    wgmma_wait<0>();
    release(c - 1, ra);
  }
  fence_regs(acc);

  // acc[4j + 2h + cc] = D[n][m], n = n0 + arow + 8h, m = m0 + 8j + 2q + cc
  const float* swe = sw + (size_t)e * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + arow + 8 * h;
    if (n >= N) continue;
    const float s_w = swe[n];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int m = m0 + 8 * j + 2 * q + cc;
        if (m < M)
          store_one(out, e, m, n, M, N, acc[4 * j + 2 * h + cc], sx,
                    s_w);
      }
  }
}

// ---------------------------------------------------------------------------
// Decode: 64 weight rows x 32 activation rows a block, split K, fixed-order
// reduction
// ---------------------------------------------------------------------------

namespace dc {
constexpr int BN = 64;        // weight rows (output columns) per block
constexpr int BM = 32;        // activation rows per block
constexpr int STAGES = 4;
constexpr int THREADS = 128 + 32;                  // one warpgroup + producer
constexpr int W_BYTES = BN * CHUNK;                // e4m3
constexpr int X_HALF = BM * CHUNK, X_BYTES = 2 * X_HALF;   // f16
constexpr int SMEM = 1024 + STAGES * (W_BYTES + X_BYTES) + 2 * STAGES * 8;
}  // namespace dc

// The split's f32 partial of a tile to part[split][tile][n - n0][m - m0];
// the last split's block to arrive adds them in split order and stores the
// tile.  acc[4j + 2h + c] = D[n, m] with n = n0 + 16 warp + lane / 4 + 8 h
// and m = m0 + 8 j + 2 (lane % 4) + c.
template <class OutT>
__device__ __forceinline__ void reduce_splits(
    const float (&acc)[16], float* __restrict__ part,
    int* __restrict__ counters, const float* __restrict__ sx,
    const float* __restrict__ sw, OutT* __restrict__ out, int e, int n0,
    int m0, int M, int N, int split, int splits, int* is_last) {
  using namespace dc;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  const int tiles = gridDim.z * gridDim.x;
  float* mine = part + ((size_t)split * tiles + tile) * (BN * BM);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int nl = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(mine + nl * BM + 8 * j + 2 * (lane % 4)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  __threadfence();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");   // the consumer warps
  if (t == 0) {
    *is_last = atomicAdd(&counters[tile], 1) == splits - 1;
    if (*is_last) counters[tile] = 0;    // ready for the next launch
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (!*is_last) return;
  __threadfence();
  // the last block adds the splits' partials in split order, 4 float4 a
  // thread, the loads of 4 splits issued before their adds
  const float* swe = sw + (size_t)e * N;
  const float4* base =
      reinterpret_cast<const float4*>(part + (size_t)tile * (BN * BM));
  const size_t stride = (size_t)tiles * (BN * BM / 4);
  float4 a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __ldcg(base + t + 128 * i);
  for (int s0 = 1; s0 < splits; s0 += 4) {        // 16 loads in flight
    float4 p[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (s0 + u < splits)
          p[u][i] = __ldcg(base + (s0 + u) * stride + t + 128 * i);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (s0 + u < splits) {
          a[i].x = __fadd_rn(a[i].x, p[u][i].x);
          a[i].y = __fadd_rn(a[i].y, p[u][i].y);
          a[i].z = __fadd_rn(a[i].z, p[u][i].z);
          a[i].w = __fadd_rn(a[i].w, p[u][i].w);
        }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qd = t + 128 * i;                    // float4 index in the tile
    const int n = n0 + qd / (BM / 4), m = m0 + (qd % (BM / 4)) * 4;
    if (n >= N) continue;
    const float v[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (m + c < M)
        store_one(out, e, m + c, n, M, N, v[c], sx, swe[n]);
  }
}

// grid (N / 64 tiles, splits, E * M / 32 tiles); split s covers chunks
// [s * cps, min((s + 1) * cps, chunks)).  part (splits, tiles, 64 x 32) f32
// and counters (tiles = E * M / 32 tiles * N / 64 tiles, zero on entry,
// left zero) are its scratch; with one split the block is its tile's last.
template <class OutT>
__global__ void __launch_bounds__(dc::THREADS)
gemm_decode_kernel(const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_x,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   OutT* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ counters, int M, int N, int K,
                   int m_tiles, int cps) {
  using namespace dc;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int is_last;
  uint8_t* sw8 = align1024(smem_raw);              // STAGES x (64 w rows)
  uint8_t* sxh = sw8 + STAGES * W_BYTES;           // STAGES x (32 x rows)
  uint64_t* full = reinterpret_cast<uint64_t*>(sxh + STAGES * X_BYTES);
  uint64_t* empty = full + STAGES;
  const int n0 = blockIdx.x * BN, split = blockIdx.y, splits = gridDim.y;
  const int e = blockIdx.z / m_tiles, m0 = (blockIdx.z % m_tiles) * BM;
  const int chunks = (K + CHUNK - 1) / CHUNK;
  const int c0 = split * cps, c1 = min(chunks, c0 + cps);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {                                  // producer
    if (lane == 0) {
      prefetch_map(&map_w);
      prefetch_map(&map_x);
      for (int c = c0; c < c1; ++c) {
        const int i = c - c0, s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], W_BYTES + X_BYTES);
        tma_load(sw8 + s * W_BYTES, &map_w, &full[s], c * CHUNK, n0, e);
        uint8_t* xs = sxh + s * X_BYTES;
        tma_load(xs, &map_x, &full[s], c * CHUNK, m0, e);
        tma_load(xs + X_HALF, &map_x, &full[s], c * CHUNK + CHUNK / 2, m0,
                 e);
      }
    }
    return;
  }

  const int arow = 16 * warp + lane / 4, q = lane % 4;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  uint32_t ra[32], rb[32];
  auto load = [&](int c, uint32_t(&a)[32]) {
    const int s = (c - c0) % STAGES;
    mbar_wait(&full[s], ((c - c0) / STAGES) & 1);
    load_a_chunk(sw8 + s * W_BYTES, arow, q, a);
  };
  auto issue = [&](int c, uint32_t(&a)[32]) {
    const uint8_t* xs = sxh + ((c - c0) % STAGES) * X_BYTES;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < CHUNK / 16; ++k)
      wgmma_f16_m64n32k16(acc, a + 4 * k, desc_f16_step(xs, BM, k), 1);
    wgmma_commit();
  };
  auto release = [&](int c, uint32_t(&a)[32]) {
    fence_regs(a);
    if (lane == 0) mbar_arrive(&empty[(c - c0) % STAGES]);
  };
  load(c0, ra);
  issue(c0, ra);
  int c = c0 + 1;
  for (; c + 1 < c1; c += 2) {
    load(c, rb);
    issue(c, rb);
    wgmma_wait<1>();
    release(c - 1, ra);
    load(c + 1, ra);
    issue(c + 1, ra);
    wgmma_wait<1>();
    release(c, rb);
  }
  if (c < c1) {
    load(c, rb);
    issue(c, rb);
    wgmma_wait<1>();
    release(c - 1, ra);
    wgmma_wait<0>();
    release(c, rb);
  } else {
    wgmma_wait<0>();
    release(c - 1, ra);
  }
  fence_regs(acc);
  reduce_splits(acc, part, counters, sx, sw, out, e, n0, m0, M, N, split,
                splits, &is_last);
}

// lets the GEMM kernels take their dynamic shared memory, once per device
void allow_smem() {
  static unsigned done = 0;                     // a bit per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (done & (1u << dev)) return;
  cudaFuncSetAttribute(gemm_decode_kernel<__nv_bfloat16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, dc::SMEM);
  cudaFuncSetAttribute(gemm_decode_kernel<float>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, dc::SMEM);
  cudaFuncSetAttribute(gemm_prefill_kernel<__nv_bfloat16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, pf::SMEM);
  cudaFuncSetAttribute(gemm_prefill_kernel<float>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, pf::SMEM);
  done |= 1u << dev;
}

int padded(int K) { return (K + CHUNK - 1) / CHUNK * CHUNK; }

int quantize(const void* x, void* xh, void* sx, const void* fixed, long rows,
             int K, void* counters, int n_counters, cudaStream_t st) {
  const bool vec = K % 8 == 0 && ((uintptr_t)x & 15) == 0;
  auto kernel =
      vec ? quantize_rows_kernel<true> : quantize_rows_kernel<false>;
  kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const __nv_bfloat16*)x, (uint32_t*)xh, (float*)sx, rows, K, padded(K),
      (const float*)fixed, (int*)counters, n_counters);
  return (int)cudaGetLastError();
}

template <class OutT>
void launch(const CUtensorMap& map_w, const CUtensorMap& map_x,
            const void* sx, const void* sw, void* out, void* part,
            void* counters, int E, int M, int N, int K, int splits, int cps,
            cudaStream_t st) {
  if (splits > 0) {
    const int m_tiles = (M + dc::BM - 1) / dc::BM;
    dim3 grid((N + dc::BN - 1) / dc::BN, splits, E * m_tiles);
    gemm_decode_kernel<OutT><<<grid, dc::THREADS, dc::SMEM, st>>>(
        map_w, map_x, (const float*)sx, (const float*)sw, (OutT*)out,
        (float*)part, (int*)counters, M, N, K, m_tiles, cps);
  } else {
    dim3 grid((N + pf::BN - 1) / pf::BN, (M + pf::BM - 1) / pf::BM, E);
    gemm_prefill_kernel<OutT><<<grid, pf::THREADS, pf::SMEM, st>>>(
        map_w, map_x, (const float*)sx, (const float*)sw, (OutT*)out, M, N,
        K);
  }
}

int gemm(const void* xh, const void* w, const void* sx, const void* sw,
         void* out, int out_f32, void* part, void* counters, int E, int M,
         int N, int K, long long ldw, long long sew, int splits, int cps,
         cudaStream_t st) {
  const bool decode = splits > 0;
  const uint64_t kp = padded(K);
  CUtensorMap map_x, map_w;
  int code = make_f16_k_major_map(&map_x, xh, kp, M, E, kp * 2,
                                  (uint64_t)M * kp * 2,
                                  decode ? dc::BM : pf::BM);
  if (code != 0) return code;
  code = make_k_major_map(&map_w, w, K, N, E, ldw, sew,
                          decode ? dc::BN : pf::BN);
  if (code != 0) return code;
  allow_smem();
  if (out_f32)
    launch<float>(map_w, map_x, sx, sw, out, part, counters, E, M, N, K,
                  splits, cps, st);
  else
    launch<__nv_bfloat16>(map_w, map_x, sx, sw, out, part, counters, E, M,
                          N, K, splits, cps, st);
  return (int)cudaGetLastError();
}

}  // namespace

// x (E, M, K) bf16 contiguous; w (E, K, N) e4m3 K-major: element (e, k, n)
// at byte e * sew + n * ldw + k; sw (E, N) f32; out (E, M, N) bf16, or f32
// when out_f32;
// scratch xh (E, M, Kp) f16, Kp = K rounded up to 128, and sx (E, M) f32;
// `fixed` null for the dynamic scales, else a device pointer to the one
// static scale.  splits == 0 runs the prefill path; splits >= 1 the decode
// path with `splits` splits of `cps` chunks each, with part (splits * tiles
// * 2048) f32 and counters (E * ceil(M / 32) * ceil(N / 64) ints, zeroed
// here by the quantization pass) as its scratch.  Any K, N >= 1; ldw
// (>= K) and sew multiples of 16; w and the scratch 16-byte aligned, x
// 2-byte aligned.  Returns cudaGetLastError()
// after the launches, or minus the CUresult of a refused tensor-map
// encoding.
extern "C" int fp8_gemm_launch(const void* x, const void* w, const void* sw,
                               void* out, void* xh, void* sx, void* part,
                               void* counters, const void* fixed, int E,
                               int M, int N, int K, long long ldw,
                               long long sew, int splits, int cps,
                               int out_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_counters = splits > 0 ? E * ((M + dc::BM - 1) / dc::BM) *
                                          ((N + dc::BN - 1) / dc::BN)
                                    : 0;
  const int code = quantize(x, xh, sx, fixed, (long)E * M, K, counters,
                            n_counters, st);
  if (code != 0) return code;
  return gemm(xh, w, sx, sw, out, out_f32, part, counters, E, M, N, K, ldw,
              sew, splits, cps, st);
}

// The two passes apart, for timing each: the quantization pass alone, and
// the GEMM on an xh, sx it made.  The GEMM's counters must be zero on entry
// (the last block of each tile leaves its counter at zero again).
extern "C" int fp8_gemm_quantize_launch(const void* x, void* xh, void* sx,
                                        const void* fixed, long long rows,
                                        int K, void* stream) {
  return quantize(x, xh, sx, fixed, (long)rows, K, nullptr, 0,
                  (cudaStream_t)stream);
}

extern "C" int fp8_gemm_mma_launch(const void* xh, const void* w,
                                   const void* sx, const void* sw, void* out,
                                   void* part, void* counters, int E, int M,
                                   int N, int K, long long ldw, long long sew,
                                   int splits, int cps, int out_f32,
                                   void* stream) {
  return gemm(xh, w, sx, sw, out, out_f32, part, counters, E, M, N, K, ldw,
              sew, splits, cps, (cudaStream_t)stream);
}
