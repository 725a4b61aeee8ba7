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
// fp8 tensor-core peak of 1979 TFLOP/s).  The design (sm90_fp8.cuh):
//
// * The weight is stored K-major: wq (K, N) is the transpose view of an
//   (N, K) row-major array (core.quant.quantize_per_channel lays it out so
//   once, at quantization).  fp8 wgmma reads both operands K-major, so the
//   weight's tiles go from HBM to shared memory by TMA as they are.
// * Quantization pass: one warp per row, 16-byte loads of 8 bf16, the amax,
//   then the same 16-byte loads again (from L2) quantized into 8-byte stores.
// * Prefill (M >= 256): 128 x 128 output tiles, a producer warpgroup (one
//   thread) that keeps a 4-stage ring of (x, w) 128-deep chunks in flight
//   with TMA, and two consumer warpgroups, each 64 rows x 128 columns of
//   wgmma.m64n128k32 into two fragments in turn (setmaxnreg moves the
//   producer's registers to them), so one chunk's products run while the
//   previous chunk is folded.
// * Decode (M < 256): swapped operands, out^T = w^T . xq^T, so the weight's
//   N rows fill wgmma's 64-row M and the 32 activation rows are its N; K is
//   split so that about one block per SM streams the weight.  Each split
//   writes an f32 partial; the last block of a tile to arrive (a counter)
//   adds the partials in split order, so the sum does not depend on which
//   block finishes first.
// * Both paths fold every 128-deep chunk into the f32 accumulator: the
//   chunk's 4 wgmma k-steps accumulate in a fragment (the tensor cores' own
//   fp8 accumulation keeps fewer bits than f32), which is then added with
//   __fadd_rn.  The epilogue scales by sx[m] * sw[n] and rounds once to bf16.

#include "sm90_fp8.cuh"

namespace {

using namespace sm90;

// ---------------------------------------------------------------------------
// Quantization pass
// ---------------------------------------------------------------------------

constexpr int HELD = 8;   // 16-byte loads a lane keeps: rows up to 2048 wide

// x (R, K) bf16 -> xq (R, K) e4m3 bytes and sx (R) f32, one warp per row;
// K % 8 == 0.  A row of up to 2048 elements is read once and held in
// registers; a longer one is read twice (the second time from cache).
// Also zeroes `counters` (n_counters ints) for the split-K reduction of the
// GEMM launched after it on the same stream.
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     uint8_t* __restrict__ xq, float* __restrict__ sx, long R,
                     int K, int* __restrict__ counters, int n_counters) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n_counters;
       i += (long)gridDim.x * blockDim.x)
    counters[i] = 0;
  const int lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= R) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + row * K);
  uint2* dst = reinterpret_cast<uint2*>(xq + row * K);
  const int vecs = K / 8;
  const bool held = vecs <= 32 * HELD;
  uint4 v[HELD];
  float a = 0.0f;
  if (held) {
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < vecs ? src[c] : make_uint4(0, 0, 0, 0);
      a = amax8(v[i], a);
    }
  } else {
    for (int c = lane; c < vecs; c += 32) a = amax8(src[c], a);
  }
  for (int o = 16; o > 0; o /= 2)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  const float s = __fdiv_rn(fmaxf(a, 1e-12f), FP8_MAX);
  if (lane == 0) sx[row] = s;
  if (held) {
#pragma unroll
    for (int i = 0; i < HELD; ++i) {
      const int c = lane + 32 * i;
      if (c < vecs) dst[c] = quant8(v[i], s);
    }
  } else {
    for (int c = lane; c < vecs; c += 32) dst[c] = quant8(src[c], s);
  }
}

// (acc * sx) * sw rounded once to bf16, for columns n and n + 1 of a row
__device__ __forceinline__ void store_pair(__nv_bfloat16* __restrict__ row,
                                           int n, int N, float a0, float a1,
                                           float s_x,
                                           const float* __restrict__ sw) {
  if (n >= N) return;
  const float v0 = __fmul_rn(__fmul_rn(a0, s_x), sw[n]);
  if (n + 1 < N) {
    const float v1 = __fmul_rn(__fmul_rn(a1, s_x), sw[n + 1]);
    if (N % 2 == 0) {
      *reinterpret_cast<__nv_bfloat162*>(row + n) =
          __floats2bfloat162_rn(v0, v1);
      return;
    }
    row[n + 1] = __float2bfloat16_rn(v1);
  }
  row[n] = __float2bfloat16_rn(v0);
}

// ---------------------------------------------------------------------------
// Prefill: TMA ring + two consumer warpgroups of m64n128k32
// ---------------------------------------------------------------------------

namespace pf {
constexpr int BM = 128, BN = 128, STAGES = 4, CONSUMERS = 2;
// + a producer warpgroup (one thread issues the copies): registers are
// handed out per warpgroup, so it gives its share to the consumers
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int A_BYTES = BM * CHUNK, B_BYTES = BN * CHUNK;
constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8;
}  // namespace pf

__global__ void __launch_bounds__(pf::THREADS, 1)
gemm_prefill_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using namespace pf;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align1024(smem_raw);               // STAGES x (BM x 128)
  uint8_t* sb = sa + STAGES * A_BYTES;             // STAGES x (BN x 128)
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_BYTES);
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
      prefetch_map(&map_x);
      prefetch_map(&map_w);
      for (int c = 0; c < chunks; ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) mbar_wait(&empty[s], (c / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
        tma_load(sa + s * A_BYTES, &map_x, &full[s], c * CHUNK, m0, e);
        tma_load(sb + s * B_BYTES, &map_w, &full[s], c * CHUNK, n0, e);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  // Two fragments in turn: chunk c + 1's products run on the tensor cores
  // while chunk c's fragment is folded into acc, in chunk order.
  const int wg = warp / 4;                          // rows 64 wg .. + 63
  float acc[64], fa[64], fb[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = fa[i] = fb[i] = 0.0f;
  auto issue = [&](int c, float(&f)[64]) {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    const uint64_t da = desc_sw128(sa + s * A_BYTES + wg * 64 * CHUNK);
    const uint64_t db = desc_sw128(sb + s * B_BYTES);
    fence_regs(f);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k)
      wgmma_m64n128k32(f, desc_k(da, k), desc_k(db, k), k);
    wgmma_commit();
  };
  auto retire = [&](int c, float(&f)[64]) {      // after chunk c is done
    fence_regs(f);
    if (lane == 0) mbar_arrive(&empty[c % STAGES]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], f[i]);
  };
  issue(0, fa);
  int c = 1;
  for (; c + 1 < chunks; c += 2) {
    issue(c, fb);
    wgmma_wait<1>();
    retire(c - 1, fa);
    issue(c + 1, fa);
    wgmma_wait<1>();
    retire(c, fb);
  }
  if (c < chunks) {
    issue(c, fb);
    wgmma_wait<1>();
    retire(c - 1, fa);
    wgmma_wait<0>();
    retire(c, fb);
  } else {
    wgmma_wait<0>();
    retire(c - 1, fa);
  }

  const int t = threadIdx.x % 128;
  const int row0 = m0 + wg * 64 + 16 * (t / 32) + lane / 4;
  const float* swe = sw + (size_t)e * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m >= M) continue;
    const float s_x = sx[(size_t)e * M + m];
    __nv_bfloat16* orow = out + ((size_t)e * M + m) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store_pair(orow, n0 + 8 * j + 2 * (lane % 4), N, acc[4 * j + 2 * h],
                 acc[4 * j + 2 * h + 1], s_x, swe);
  }
}

// ---------------------------------------------------------------------------
// Decode: swapped operands, split K, fixed-order reduction
// ---------------------------------------------------------------------------

namespace dc {
constexpr int BN = 64;        // weight rows (output columns) per block
constexpr int BM = 32;        // activation rows per block
constexpr int STAGES = 4;
constexpr int THREADS = 128 + 32;                  // one warpgroup + producer
constexpr int A_BYTES = BN * CHUNK, B_BYTES = BM * CHUNK;
constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8;
}  // namespace dc

// grid (N / 64 tiles, splits, E * M / 32 tiles); split s covers chunks
// [s * cps, min((s + 1) * cps, chunks)).  part (splits, tiles, 64 x 32) f32
// and counters (tiles = E * M / 32 tiles * N / 64 tiles, zero on entry,
// left zero) are its scratch; with one split the block is its tile's last.
__global__ void __launch_bounds__(dc::THREADS)
gemm_decode_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ counters, int M, int N, int K,
                   int m_tiles, int cps) {
  using namespace dc;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int is_last;
  uint8_t* sa = align1024(smem_raw);               // STAGES x (64 w rows)
  uint8_t* sb = sa + STAGES * A_BYTES;             // STAGES x (32 x rows)
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_BYTES);
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
        mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
        tma_load(sa + s * A_BYTES, &map_w, &full[s], c * CHUNK, n0, e);
        tma_load(sb + s * B_BYTES, &map_x, &full[s], c * CHUNK, m0, e);
      }
    }
    return;
  }

  float acc[16], frag[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = frag[i] = 0.0f;
  for (int c = c0; c < c1; ++c) {
    const int i = c - c0, s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint64_t da = desc_sw128(sa + s * A_BYTES);
    const uint64_t db = desc_sw128(sb + s * B_BYTES);
    fence_regs(frag);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k)
      wgmma_m64n32k32(frag, desc_k(da, k), desc_k(db, k), k);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(frag);
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = __fadd_rn(acc[j], frag[j]);
  }

  // acc[4j + 2h + c] = D[n, m] with n = n0 + 16 warp + lane / 4 + 8 h and
  // m = m0 + 8 j + 2 (lane % 4) + c goes to the split's partial, tile-major:
  // part[split][tile][n - n0][m - m0]
  const int t = threadIdx.x;
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
    is_last = atomicAdd(&counters[tile], 1) == splits - 1;
    if (is_last) counters[tile] = 0;     // ready for the next launch
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (!is_last) return;
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
    const int q = t + 128 * i;                     // float4 index in the tile
    const int n = n0 + q / (BM / 4), m = m0 + (q % (BM / 4)) * 4;
    if (n >= N) continue;
    const float v[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (m + c < M)
        out[((size_t)e * M + m + c) * N + n] = __float2bfloat16_rn(__fmul_rn(
            __fmul_rn(v[c], sx[(size_t)e * M + m + c]), swe[n]));
  }
}

// lets both GEMM kernels take their dynamic shared memory, once per device
void allow_smem() {
  static unsigned done = 0;                     // a bit per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (done & (1u << dev)) return;
  cudaFuncSetAttribute(gemm_decode_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, dc::SMEM);
  cudaFuncSetAttribute(gemm_prefill_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, pf::SMEM);
  done |= 1u << dev;
}

int quantize(const void* x, void* xq, void* sx, long rows, int K,
             void* counters, int n_counters, cudaStream_t st) {
  quantize_rows_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const __nv_bfloat16*)x, (uint8_t*)xq, (float*)sx, rows, K,
      (int*)counters, n_counters);
  return (int)cudaGetLastError();
}

int gemm(const void* xq, const void* w, const void* sx, const void* sw,
         void* out, void* part, void* counters, int E, int M, int N, int K,
         long long ldw, long long sew, int splits, int cps, cudaStream_t st) {
  const bool decode = splits > 0;
  CUtensorMap map_x, map_w;
  int code = make_k_major_map(&map_x, xq, K, M, E, K, (uint64_t)M * K,
                              decode ? dc::BM : pf::BM);
  if (code != 0) return code;
  code = make_k_major_map(&map_w, w, K, N, E, ldw, sew,
                          decode ? dc::BN : pf::BN);
  if (code != 0) return code;
  allow_smem();
  if (decode) {
    const int m_tiles = (M + dc::BM - 1) / dc::BM;
    dim3 grid((N + dc::BN - 1) / dc::BN, splits, E * m_tiles);
    gemm_decode_kernel<<<grid, dc::THREADS, dc::SMEM, st>>>(
        map_x, map_w, (const float*)sx, (const float*)sw,
        (__nv_bfloat16*)out, (float*)part, (int*)counters, M, N, K, m_tiles,
        cps);
  } else {
    dim3 grid((N + pf::BN - 1) / pf::BN, (M + pf::BM - 1) / pf::BM, E);
    gemm_prefill_kernel<<<grid, pf::THREADS, pf::SMEM, st>>>(
        map_x, map_w, (const float*)sx, (const float*)sw,
        (__nv_bfloat16*)out, M, N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (E, M, K) bf16 contiguous; w (E, K, N) e4m3 K-major: element (e, k, n)
// at byte e * sew + n * ldw + k; sw (E, N) f32; out (E, M, N) bf16;
// scratch xq (E, M, K) bytes and sx (E, M) f32.  splits == 0 runs the
// prefill path; splits >= 1 the decode path with `splits` splits of `cps`
// chunks each, with part (splits * tiles * 2048) f32 and counters
// (E * ceil(M / 32) * ceil(N / 64) ints, zeroed here by the quantization
// pass) as its scratch.  K % 16 == 0, ldw and sew multiples of 16, pointers
// 16-byte aligned.  Returns cudaGetLastError() after the launches, or minus
// the CUresult of a refused tensor-map encoding.
extern "C" int fp8_gemm_launch(const void* x, const void* w, const void* sw,
                               void* out, void* xq, void* sx, void* part,
                               void* counters, int E, int M, int N, int K,
                               long long ldw, long long sew, int splits,
                               int cps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_counters = splits > 0 ? E * ((M + dc::BM - 1) / dc::BM) *
                                          ((N + dc::BN - 1) / dc::BN)
                                    : 0;
  const int code =
      quantize(x, xq, sx, (long)E * M, K, counters, n_counters, st);
  if (code != 0) return code;
  return gemm(xq, w, sx, sw, out, part, counters, E, M, N, K, ldw, sew,
              splits, cps, st);
}

// The two passes apart, for timing each: the quantization pass alone, and
// the GEMM on an xq, sx it made.  The GEMM's counters must be zero on entry
// (the last block of each tile leaves its counter at zero again).
extern "C" int fp8_gemm_quantize_launch(const void* x, void* xq, void* sx,
                                        long long rows, int K, void* stream) {
  return quantize(x, xq, sx, (long)rows, K, nullptr, 0,
                  (cudaStream_t)stream);
}

extern "C" int fp8_gemm_mma_launch(const void* xq, const void* w,
                                   const void* sx, const void* sw, void* out,
                                   void* part, void* counters, int E, int M,
                                   int N, int K, long long ldw, long long sew,
                                   int splits, int cps, void* stream) {
  return gemm(xq, w, sx, sw, out, part, counters, E, M, N, K, ldw, sew,
              splits, cps, (cudaStream_t)stream);
}
