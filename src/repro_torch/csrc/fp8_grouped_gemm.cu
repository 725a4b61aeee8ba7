// Kernel fp8_grouped_gemm: block-scaled fp8 grouped GEMM (the MoE experts).
//
// Replaces the Pallas kernel repro/kernels/fp8_grouped_gemm/kernel.py
// (_grouped_kernel / fp8_grouped_gemm_pallas).  Per expert e:
//   x (C, K) bf16, wq (K, N) e4m3, sw (K/128, N/128) f32 -> out (C, N) bf16
// For each 128-deep slice kb of K, the activation scale of row c is
//   sx[c, kb] = max(amax |x[c, kb*128 : kb*128+128]|, 1e-12) / 448
// (the 1 x 128 blocks), x is cast to e4m3 with it (true division, clip,
// round to nearest), and the slice's partial product, an f32 sum of exact
// products, is scaled and accumulated as the Pallas kernel does, slice
// after slice:
//   acc = acc + (part[c, n] * sx[c, kb]) * sw[kb, n / 128]        f32
// Nothing is folded into bf16 operands.
//
// What bounds it on the H100: at a decode step (C = 8 rows per expert) the
// E*K*N weight bytes (16 experts x 8 MiB a product), so bytes over
// 3.35 TB/s; at a prefill (C ~ 3k) the 2*E*C*N*K operations over the
// tensor-core peak.  The design (sm90_fp8.cuh, as fp8_gemm.cu):
//
// * The partials are f32 sums: the main loops run 16-bit wgmma (m64nNk16,
//   f32 accumulation) on f16 copies of the e4m3 values, which are exact
//   (sm90_fp8.cuh, "16-bit operands").  e4m3 wgmma, whose accumulator keeps
//   about 14 bits, put 6.6-6.8% of the bf16 outputs off the correctly
//   rounded result with a fold into f32 every 128 deep, and 2.6-2.7% with
//   one every 32 (PERF.md, ROADMAP C2).
// * The weight is stored K-major: wq (E, K, N) is the transpose view of an
//   (E, N, K) array (core.quant.quantize_blockwise lays it out so once, at
//   quantization), so its e4m3 tiles go from HBM to shared memory by TMA
//   as they are, the expert being the tensor map's batch dimension.  Each
//   consumer thread converts its own A fragment from the tile in registers,
//   so the weight's rows are wgmma's M at every size: out^T = w^T . xq^T.
// * Quantization pass: 16 lanes per 1 x 128 block, a 16-byte load of 8 bf16
//   each (at prefill sizes 4 blocks a lane group, their loads in flight
//   together), the block's amax by shuffles within the 16 lanes, the block
//   cast to e4m3 and written as f16 in the chunk's k order (the B operand,
//   which TMA copies to shared memory as it is).
//   The scales go to sx (E, K/128, C): a chunk's row scales are contiguous.
// * Prefill (C > 32): tiles of 128 weight rows x 128 expert rows (a tile
//   never straddles a 128-column scale block, so sw is one scalar per
//   chunk), a producer warpgroup whose one thread keeps a 4-stage TMA ring
//   of 128-deep chunks in flight (w rows, x rows and the rows' 128 sx
//   scales), and two consumer warpgroups of 64 weight rows each: per chunk
//   8 x wgmma.m64n128k16 into a fresh fragment, folded into acc once done,
//   the next chunk's A fragments loaded and converted while the MMAs run
//   (setmaxnreg 40 / 232).  The blocks are persistent, one per SM walking
//   tiles, so the ring runs on into a block's next tile while it stores the
//   last: a tile's start and end cost no pipeline fill.
// * Decode (C <= 32): 64 weight rows fill wgmma's 64-row M and the expert's
//   C rows, zero-filled by TMA to BC = 8, 16 or 32, are its N
//   (wgmma.m64nBCk16).  One block per (64 output columns, expert, BC rows)
//   streams 64 x K bytes of the expert's weight through a 4-stage ring:
//   1024 blocks at gate/up, 512 at down.
// * Every fold is acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(part, sx), sw)),
//   in chunk order, the order of the Pallas kernel and the plain version.
//   At decode, the block's sx slab (K/128 x its rows) and sw column are
//   read into shared memory once, while the first chunks land; at prefill,
//   sx comes with each stage and sw is read two chunks ahead of its fold.
//   The epilogue rounds acc once to bf16.

#include "sm90_fp8.cuh"

namespace {

using namespace sm90;

constexpr int B = 128;   // the block granularity of the scales

// ---------------------------------------------------------------------------
// Quantization pass: 1 x 128 blocks
// ---------------------------------------------------------------------------

// x (R = E * C, K) bf16 -> xh (R, K) f16 in the chunks' k order and sx
// (E, K / 128, Cp) f32, Cp = C rounded up to a multiple of 4 (TMA's 16-byte
// row strides); 16 lanes per (row, 128-block), a lane group on QB
// neighbouring blocks of the flat (row, block) order, their loads issued
// before any arithmetic (QB = 4 at prefill sizes; 1 at decode sizes, where
// more threads hide more latency)
template <int QB>
__global__ void __launch_bounds__(256)
quantize_blocks_kernel(const __nv_bfloat16* __restrict__ x,
                       uint32_t* __restrict__ xh, float* __restrict__ sx,
                       long R, int C, int K) {
  const int KB = K / B, sub = threadIdx.x % 16, Cp = (C + 3) / 4 * 4;
  const long g0 = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 16 * QB;
  uint4 v[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    const long gid = g0 + j;
    v[j] = gid < R * KB ? *reinterpret_cast<const uint4*>(
                              x + gid * B + 8 * sub)
                        : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    const long gid = g0 + j;
    float a = amax8(v[j], 0.0f);
#pragma unroll
    for (int o = 8; o > 0; o /= 2)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (gid >= R * KB) continue;
    const float s = __fdiv_rn(fmaxf(a, 1e-12f), FP8_MAX);
    // block gid is chunk gid % KB of row gid / KB: its words start at
    // gid * 64
    store_perm8(xh + gid * (B / 2), sub, quant8_f16(v[j], s));
    if (sub == 0) {
      const long row = gid / KB, e = row / C, c = row % C;
      sx[((size_t)e * KB + gid % KB) * Cp + c] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Prefill: TMA ring + two consumer warpgroups of m64n128k16
// ---------------------------------------------------------------------------

namespace pf {
constexpr int BN = 128;       // weight rows (output columns): 64 a consumer
constexpr int BM = 128;       // expert rows: wgmma's N
constexpr int STAGES = 4, CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int W_BYTES = BN * CHUNK;             // e4m3
constexpr int X_HALF = BM * CHUNK, X_BYTES = 2 * X_HALF;   // f16
constexpr int S_BYTES = BM * 4;
constexpr int SMEM = 1024 + STAGES * (W_BYTES + X_BYTES + S_BYTES) +
                     2 * STAGES * 8;
}  // namespace pf

// Persistent: block b takes tiles b, b + gridDim.x, ..; tile t is (column
// tile t % (N / 128), row tile t / (N / 128) % ceil(C / 128), expert ..).
// Each ring stage holds a chunk's w rows, x rows and the rows' sx slice,
// so the producer runs on into the next tile while the consumers store
// this one's.
__global__ void __launch_bounds__(pf::THREADS, 1)
grouped_prefill_kernel(const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_sx,
                       const float* __restrict__ sw,
                       __nv_bfloat16* __restrict__ out, int E, int C, int N,
                       int K) {
  using namespace pf;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sw8 = align1024(smem_raw);              // STAGES x (BN x 128)
  uint8_t* sxh = sw8 + STAGES * W_BYTES;           // STAGES x (BM x 128) f16
  float* ssx = reinterpret_cast<float*>(sxh + STAGES * X_BYTES);  // x BM
  uint64_t* full = reinterpret_cast<uint64_t*>(ssx + STAGES * BM);
  uint64_t* empty = full + STAGES;
  const int KB = K / B, NB = N / B, n_tiles = N / BN;
  const int m_tiles = (C + BM - 1) / BM, tiles = n_tiles * m_tiles * E;
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
      prefetch_map(&map_sx);
      int g = 0;                                    // chunks issued so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = (t % n_tiles) * BN;
        const int m0 = (t / n_tiles % m_tiles) * BM, e = t / n_tiles / m_tiles;
        for (int c = 0; c < KB; ++c, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(&empty[s], (g / STAGES - 1) & 1);
          mbar_expect_tx(&full[s], W_BYTES + X_BYTES + S_BYTES);
          tma_load(sw8 + s * W_BYTES, &map_w, &full[s], c * CHUNK, n0, e);
          uint8_t* xs = sxh + s * X_BYTES;
          tma_load(xs, &map_x, &full[s], c * CHUNK, m0, e);
          tma_load(xs + X_HALF, &map_x, &full[s], c * CHUNK + CHUNK / 2, m0,
                   e);
          tma_load(ssx + s * BM, &map_sx, &full[s], m0, c, e);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  // consumer warpgroup wg: weight rows 64 wg .. + 63 of the tile; this
  // thread's A rows are arow and arow + 8
  const int wg = warp / 4, q = lane % 4;
  const int arow = 64 * wg + 16 * (warp % 4) + lane / 4;
  float acc[64], frag[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) frag[i] = 0.0f;
  uint32_t ra[32], rb[32];
  int g = 0;                                        // chunks consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, g += KB) {
    const int n0 = (t % n_tiles) * BN;
    const int m0 = (t / n_tiles % m_tiles) * BM, e = t / n_tiles / m_tiles;
    // the column block's sw of every chunk, read two chunks ahead of its
    // fold: swc[kb * NB]
    const float* swc = sw + (size_t)e * KB * NB + n0 / B;
    float sw0 = swc[0], sw1 = KB > 1 ? swc[NB] : 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    auto load = [&](int c, uint32_t(&a)[32]) {
      const int s = (g + c) % STAGES;
      mbar_wait(&full[s], ((g + c) / STAGES) & 1);
      load_a_chunk(sw8 + s * W_BYTES, arow, q, a);
    };
    auto issue = [&](int c, uint32_t(&a)[32]) {
      const uint8_t* xs = sxh + ((g + c) % STAGES) * X_BYTES;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < CHUNK / 16; ++k)
        wgmma_f16_m64n128k16(frag, a + 4 * k, desc_f16_step(xs, BM, k), k);
      wgmma_commit();
    };
    // after chunk c's MMAs: frag[4j + 2h + cc] = part[m][n] with expert row
    // m = m0 + 8j + 2q + cc and n = n0 + arow + 8h
    auto retire = [&](int c, uint32_t(&a)[32]) {
      fence_regs(frag);
      fence_regs(a);
      const int s = (g + c) % STAGES;
      const float* sxs = ssx + s * BM + 2 * q;
      const float s_w = sw0;
      sw0 = sw1;
      sw1 = c + 2 < KB ? swc[(size_t)(c + 2) * NB] : 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 sxp = *reinterpret_cast<const float2*>(sxs + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(frag[i], sxp.x),
                                               s_w));
          acc[i + 1] = __fadd_rn(
              acc[i + 1], __fmul_rn(__fmul_rn(frag[i + 1], sxp.y), s_w));
        }
      }
      __syncwarp();                    // the warp has read the stage's sx
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    // chunk c + 1's fragments are loaded and converted while chunk c's
    // MMAs run; chunk c is folded before chunk c + 1's MMAs reuse frag.
    // No MMA is in flight across the loop's back edge (ptxas would wait
    // for it there to copy the fragment).
    load(0, ra);
    for (int c = 0; c < KB; c += 2) {
      issue(c, ra);
      if (c + 1 < KB) load(c + 1, rb);
      wgmma_wait<0>();
      retire(c, ra);
      if (c + 1 < KB) {
        issue(c + 1, rb);
        if (c + 2 < KB) load(c + 2, ra);
        wgmma_wait<0>();
        retire(c + 1, rb);
      }
    }

    // acc[4j + 2h + cc] = out[m0 + 8j + 2q + cc, n0 + arow + 8h]
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int m = m0 + 8 * j + 2 * q + cc;
        if (m >= C) continue;
        __nv_bfloat16* orow = out + ((size_t)e * C + m) * N + n0 + arow;
        orow[0] = __float2bfloat16_rn(acc[4 * j + cc]);
        orow[8] = __float2bfloat16_rn(acc[4 * j + 2 + cc]);
      }
  }
}

// ---------------------------------------------------------------------------
// Decode: the expert's rows as wgmma's N
// ---------------------------------------------------------------------------

namespace dc {
constexpr int BN = 64;        // weight rows (output columns) per block
constexpr int STAGES = 4;
constexpr int THREADS = 128 + 32;                  // one warpgroup + producer
constexpr int W_BYTES = BN * CHUNK;                // e4m3
template <int BC>
struct Tile {
  static constexpr int X_HALF = BC * CHUNK;        // f16, one 64-deep box
  static constexpr int X_BYTES = 2 * X_HALF;
  static constexpr int RING = STAGES * (W_BYTES + X_BYTES);
  // + the barriers, then sx (KB x BC) and sw (KB) f32
  static int smem(int KB) {
    return 1024 + RING + 2 * STAGES * 8 + KB * (BC + 1) * 4;
  }
};
}  // namespace dc

template <int BC>
__device__ __forceinline__ void wgmma_bc(float (&d)[BC / 2],
                                         const uint32_t* a, uint64_t b,
                                         int scale_d);
template <>
__device__ __forceinline__ void wgmma_bc<8>(float (&d)[4], const uint32_t* a,
                                            uint64_t b, int scale_d) {
  wgmma_f16_m64n8k16(d, a, b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_bc<16>(float (&d)[8],
                                             const uint32_t* a, uint64_t b,
                                             int scale_d) {
  wgmma_f16_m64n16k16(d, a, b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_bc<32>(float (&d)[16],
                                             const uint32_t* a, uint64_t b,
                                             int scale_d) {
  wgmma_f16_m64n32k16(d, a, b, scale_d);
}

// the block's sx slab (K/128 x BC rows) and sw column into shared memory
template <int BC>
__device__ __forceinline__ void stage_scales(
    float* __restrict__ sxs, float* __restrict__ sws,
    const float* __restrict__ sx, const float* __restrict__ sw, int e,
    int m0, int n0, int C, int KB, int NB) {
  const int t = threadIdx.x;                        // 0 .. 127
  const int Cp = (C + 3) / 4 * 4;
  const float* sxe = sx + (size_t)e * KB * Cp;
  for (int i = t; i < KB * BC; i += 128) {
    const int kb = i / BC, r = i % BC;
    sxs[i] = m0 + r < C ? sxe[(size_t)kb * Cp + m0 + r] : 0.0f;
  }
  for (int kb = t; kb < KB; kb += 128)
    sws[kb] = sw[((size_t)e * KB + kb) * NB + n0 / B];
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// acc[4j + 2h + cc] = out[m0 + 8j + 2 (lane % 4) + cc, n0 + 16 warp +
// lane / 4 + 8h], rounded once to bf16
template <int R>
__device__ __forceinline__ void store_decode(
    const float (&acc)[R], __nv_bfloat16* __restrict__ out, int e, int m0,
    int n0, int C, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = n0 + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int m = m0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    if (m < C) out[((size_t)e * C + m) * N + n] = __float2bfloat16_rn(acc[i]);
  }
}

// grid (N / 64, E, ceil(C / BC))
template <int BC>
__global__ void __launch_bounds__(dc::THREADS)
grouped_decode_kernel(const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_x,
                      const float* __restrict__ sx,
                      const float* __restrict__ sw,
                      __nv_bfloat16* __restrict__ out, int C, int N, int K) {
  using namespace dc;
  constexpr int X_HALF = Tile<BC>::X_HALF, X_BYTES = Tile<BC>::X_BYTES;
  constexpr int R = BC / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sw8 = align1024(smem_raw);              // STAGES x (64 w rows)
  uint8_t* sxh = sw8 + STAGES * W_BYTES;           // STAGES x (BC x rows)
  uint64_t* full = reinterpret_cast<uint64_t*>(sxh + STAGES * X_BYTES);
  uint64_t* empty = full + STAGES;
  float* sxs = reinterpret_cast<float*>(empty + STAGES);   // [kb][col]
  const int KB = K / B, NB = N / B;
  float* sws = sxs + KB * BC;                                // [kb]
  const int n0 = blockIdx.x * BN, e = blockIdx.y, m0 = blockIdx.z * BC;
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
      for (int c = 0; c < KB; ++c) {
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
  stage_scales<BC>(sxs, sws, sx, sw, e, m0, n0, C, KB, NB);

  // frag[4j + 2h + cc] = D[n = n0 + 16 warp + lane / 4 + 8 h][m = m0 + 8j
  // + 2 (lane % 4) + cc]: the fold scales column m by sx[m, kb]
  const int arow = 16 * warp + lane / 4, q = lane % 4;
  float acc[R], frag[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = frag[i] = 0.0f;
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
      wgmma_bc<BC>(frag, a + 4 * k, desc_f16_step(xs, BC, k), k);
    wgmma_commit();
  };
  auto retire = [&](int c, uint32_t(&a)[32]) {
    fence_regs(frag);
    fence_regs(a);
    if (lane == 0) mbar_arrive(&empty[c % STAGES]);
    const float s_w = sws[c];
    const float* sxc = sxs + c * BC + 2 * q;
#pragma unroll
    for (int i = 0; i < R; ++i)
      acc[i] = __fadd_rn(
          acc[i],
          __fmul_rn(__fmul_rn(frag[i], sxc[8 * (i / 4) + i % 2]), s_w));
  };
  load(0, ra);
  for (int c = 0; c < KB; c += 2) {      // as in the prefill kernel
    issue(c, ra);
    if (c + 1 < KB) load(c + 1, rb);
    wgmma_wait<0>();
    retire(c, ra);
    if (c + 1 < KB) {
      issue(c + 1, rb);
      if (c + 2 < KB) load(c + 2, ra);
      wgmma_wait<0>();
      retire(c + 1, rb);
    }
  }
  store_decode<R>(acc, out, e, m0, n0, C, N);
}

// lets the GEMM kernels take up to the card's dynamic shared memory, once
// per device
void allow_smem() {
  static unsigned done = 0;                     // a bit per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (done & (1u << dev)) return;
  int most = 0;
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncSetAttribute(grouped_prefill_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, pf::SMEM);
  cudaFuncSetAttribute(grouped_decode_kernel<8>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  cudaFuncSetAttribute(grouped_decode_kernel<16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  cudaFuncSetAttribute(grouped_decode_kernel<32>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  done |= 1u << dev;
}

int quantize(const void* x, void* xh, void* sx, int E, int C, int K,
             cudaStream_t st) {
  const long groups = (long)E * C * (K / B);
  if (groups >= (1L << 16))            // 16 lane groups of 4 blocks a block
    quantize_blocks_kernel<4><<<(unsigned)((groups + 63) / 64), 256, 0, st>>>(
        (const __nv_bfloat16*)x, (uint32_t*)xh, (float*)sx, (long)E * C, C,
        K);
  else
    quantize_blocks_kernel<1><<<(unsigned)((groups + 15) / 16), 256, 0, st>>>(
        (const __nv_bfloat16*)x, (uint32_t*)xh, (float*)sx, (long)E * C, C,
        K);
  return (int)cudaGetLastError();
}

template <int BC>
void launch_decode(const CUtensorMap& mw, const CUtensorMap& mx,
                   const void* sx, const void* sw, void* out, int C, int N,
                   int K, dim3 grid, cudaStream_t st) {
  grouped_decode_kernel<BC><<<grid, dc::THREADS, dc::Tile<BC>::smem(K / B),
                              st>>>(mw, mx, (const float*)sx, (const float*)sw,
                                    (__nv_bfloat16*)out, C, N, K);
}

// xh: the activations as the GEMM reads them, f16 in the chunks' k order
int gemm(const void* xh, const void* w, const void* sx, const void* sw,
         void* out, int E, int C, int N, int K, long long ldw, long long sew,
         int bc, int gx, int gy, int gz, cudaStream_t st) {
  if (bc != 0 && bc != 8 && bc != 16 && bc != 32)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w, map_sx;
  const uint32_t box = bc ? bc : pf::BM;
  int code = make_f16_k_major_map(&map_x, xh, K, C, E, (uint64_t)K * 2,
                                  (uint64_t)C * K * 2, box);
  if (code != 0) return code;
  code = make_k_major_map(&map_w, w, K, N, E, ldw, sew, bc ? dc::BN : pf::BN);
  if (code != 0) return code;
  allow_smem();
  const dim3 grid(gx, gy, gz);
  if (bc == 0) {
    const uint64_t cp = (C + 3) / 4 * 4, kb = K / B;
    code = make_f32_row_map(&map_sx, sx, C, kb, E, cp * 4, kb * cp * 4,
                            pf::BM);
    if (code != 0) return code;
    grouped_prefill_kernel<<<grid, pf::THREADS, pf::SMEM, st>>>(
        map_w, map_x, map_sx, (const float*)sw, (__nv_bfloat16*)out, E, C, N,
        K);
  } else if (bc == 8) {
    launch_decode<8>(map_w, map_x, sx, sw, out, C, N, K, grid, st);
  } else if (bc == 16) {
    launch_decode<16>(map_w, map_x, sx, sw, out, C, N, K, grid, st);
  } else {
    launch_decode<32>(map_w, map_x, sx, sw, out, C, N, K, grid, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (E, C, K) bf16 contiguous; w (E, K, N) e4m3 K-major: element (e, k, n)
// at byte e * sew + n * ldw + k; sw (E, K/128, N/128) f32; out (E, C, N)
// bf16; scratch xh (E, C, K) f16 and sx (E, K/128, Cp) f32, Cp = C rounded
// up to a multiple of 4.  K and N multiples of 128, ldw and sew multiples
// of 16, pointers 16-byte aligned.  bc == 0 runs the persistent prefill
// path on grid (gx, 1, 1), gx at most the number of 128 x 128 tiles; bc =
// 8, 16 or 32 the decode path on (N / 64, E, ceil(C / bc)).  Returns
// cudaGetLastError() after the launches, or minus the CUresult of a refused
// tensor-map encoding.
extern "C" int fp8_grouped_gemm_launch(const void* x, const void* w,
                                       const void* sw, void* out, void* xh,
                                       void* sx, int E, int C, int N, int K,
                                       long long ldw, long long sew, int bc,
                                       int gx, int gy, int gz, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int code = quantize(x, xh, sx, E, C, K, st);
  if (code != 0) return code;
  return gemm(xh, w, sx, sw, out, E, C, N, K, ldw, sew, bc, gx, gy, gz, st);
}

// The two passes apart, for timing each: the quantization pass alone, and
// the GEMM on an xh, sx it made.
extern "C" int fp8_grouped_gemm_quantize_launch(const void* x, void* xh,
                                                void* sx, int E, int C, int K,
                                                void* stream) {
  return quantize(x, xh, sx, E, C, K, (cudaStream_t)stream);
}

extern "C" int fp8_grouped_gemm_mma_launch(const void* xh, const void* w,
                                           const void* sx, const void* sw,
                                           void* out, int E, int C, int N,
                                           int K, long long ldw,
                                           long long sew, int bc, int gx,
                                           int gy, int gz, void* stream) {
  return gemm(xh, w, sx, sw, out, E, C, N, K, ldw, sew, bc, gx, gy, gz,
              (cudaStream_t)stream);
}
