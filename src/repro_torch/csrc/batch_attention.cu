// Kernel batch_attention: GQA attention of a batch of query rows over a
// dense per-row KV cache, the decode attention of the contiguous slot-pool
// layout under use_attention_kernel.
//
// Replaces the Pallas kernel repro/kernels/batch_attention/kernel.py
// (_attn_kernel / batch_attention_pallas).  One block of 8 warps per (KV
// head, batch row, block of at most 16 query rows).  A block's rows are
// r = t * G + g (query position t, head g of the group), read straight from
// q's (B, T, H, hd) layout and written to out's (B, T, H * hd); the block
// loads its rows' q_pos itself.  It walks the cache in tiles of 128
// positions (64 above hd = 128); for each tile it
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
// What bounds it on the H100: bytes.  A decode step reads the valid part of
// the cache (at full width ~6.8k valid keys x 4 KV heads x 128 x 2 B for K
// and V, ~14 MB, ~4 us at 3.35 TB/s) and does ~4 operations per byte.  The
// design keeps the bytes in flight and the arithmetic off the critical path:
//   * K/V tiles stay bf16 in shared memory (64 KB a tile for hd = 128) and
//     arrive by 16-byte cp.async, neighbouring threads on neighbouring
//     addresses, into a 2-stage ring (3 stages of 64-key tiles above
//     hd = 128): the next tile is in flight while one is scored (the key
//     positions come along by 4-byte cp.async);
//   * before the loop the block marks the tiles that hold a key some row
//     of it may see (k_pos >= 0, <= the largest q_pos, inside the window of
//     the smallest) and walks only those: a tile of empty or masked keys
//     changes nothing (its p are 0 and its running max is the old one);
//   * QK^T and PV run on the tensor cores (bf16 mma.sync.m16n8k16, f32
//     accumulation; the block's <= 16 rows are one m16 tile): warp w scores
//     its groups of 8 keys against q's fragments held in registers, a warp
//     per row runs the softmax with shuffles and stores p as bf16 (exact: p
//     is rounded to bf16 anyway), and warp w computes PV for its 8-column
//     slices of hd.  Every shared row is padded by 16 bytes, so the 8 rows
//     an ldmatrix reads hit 8 distinct bank groups.
//   * The kernel is a template on hd, so every loop over hd is unrolled
//     with no guard and the fragment loads of a tile issue before its MMAs:
//     at the decode shape the time is the chain of a tile's dependent steps
//     and barriers, not its bytes, and a tile of 128 keys halves the chain
//     per key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; `bytes` 0 writes zeros instead
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The kernel's shape for head dim HD: 128-key tiles in a 2-stage ring up to
// hd = 128, 64-key tiles in a 3-stage ring above (shared memory); rows of
// K, V, q and p padded by 16 bytes.
template <int HD>
struct Cfg {
  static constexpr int TILE = HD <= 128 ? 128 : 64;
  static constexpr int STAGES = HD <= 128 ? 2 : 3;
  static constexpr int ST = HD + 8;             // padded row, bf16
  static constexpr int PST = TILE + 8;          // padded p row, bf16
  static constexpr int KSTEPS = HD / 16;        // QK^T k-steps
  static constexpr int NT = TILE / 8 / WARPS;   // key n8-tiles a warp scores
  static constexpr int SLICES = (HD / 8 + WARPS - 1) / WARPS;  // PV n8-tiles
  static constexpr int PER_LANE = TILE / 32;    // softmax keys a lane holds
};

// Byte offsets of the shared-memory regions (host and device agree).
template <int HD>
struct Layout {
  using C = Cfg<HD>;
  int k, v, kp, q, sc, ok, p, m, l, al, qp, live, total;
  __host__ __device__ explicit Layout(int n_tiles) {
    k = 0;
    v = k + C::STAGES * C::TILE * C::ST * 2;
    kp = v + C::STAGES * C::TILE * C::ST * 2;
    q = kp + C::STAGES * C::TILE * 4;
    sc = q + MAX_ROWS * C::ST * 2;
    ok = sc + MAX_ROWS * C::TILE * 4;
    p = ok + MAX_ROWS * C::TILE;
    m = p + MAX_ROWS * C::PST * 2;
    l = m + MAX_ROWS * 4;
    al = l + MAX_ROWS * 4;
    qp = al + MAX_ROWS * 4;
    live = qp + MAX_ROWS * 4;
    total = live + (n_tiles + 1) * 4;
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
batch_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos,
                       __nv_bfloat16* __restrict__ out, int T, int H, int Kv,
                       int S, float scale, int window) {
  using C = Cfg<HD>;
  constexpr int TILE = C::TILE, ST = C::ST, PST = C::PST;
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, q4 = lane % 4;       // mma fragment coordinates
  const int G = H / Kv;
  const int r0 = blockIdx.z * MAX_ROWS;
  const int nr = min(MAX_ROWS, G * T - r0);
  const int n_tiles = (S + TILE - 1) / TILE;
  const Layout<HD> lay(n_tiles);
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + lay.k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + lay.v);
  int* Kp = reinterpret_cast<int*>(smem + lay.kp);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  float* Sc = reinterpret_cast<float*>(smem + lay.sc);   // masked scores
  uint8_t* Ok = smem + lay.ok;                            // valid (row, key)
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + lay.p);
  float* Mr = reinterpret_cast<float*>(smem + lay.m);    // running max
  float* Lr = reinterpret_cast<float*>(smem + lay.l);    // running sum
  float* Al = reinterpret_cast<float*>(smem + lay.al);   // this tile's rescale
  int* Qp = reinterpret_cast<int*>(smem + lay.qp);
  int* live = reinterpret_cast<int*>(smem + lay.live);   // [n_live, tiles..]

  // q row r (t_q = r / G, g = r % G) is head kvh * G + g at position t_q;
  // rows past nr, and p, start at zero
  for (int i = tid; i < MAX_ROWS * HD / 8; i += THREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < nr) {
      const int tq = (r0 + r) / G, head = kvh * G + (r0 + r) % G;
      val = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * T + tq) * H + head) * HD + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * ST + c) = val;
  }
  for (int i = tid; i < MAX_ROWS * PST; i += THREADS)
    Ps[i] = __float2bfloat16_rn(0.0f);
  if (tid < MAX_ROWS) {
    Qp[tid] = tid < nr ? q_pos[(size_t)b * T + (r0 + tid) / G] : -1;
    Mr[tid] = NEG_INF;
    Lr[tid] = 0.0f;
    Al[tid] = 0.0f;
  }
  for (int i = tid; i <= n_tiles; i += THREADS) live[i] = 0;
  __syncthreads();

  // the tiles holding a key some row of the block may see
  int qmin = Qp[0], qmax = Qp[0];
  for (int r = 1; r < nr; ++r) {
    qmin = min(qmin, Qp[r]);
    qmax = max(qmax, Qp[r]);
  }
  for (int s = tid; s < S; s += THREADS) {
    const int kp = k_pos[(size_t)b * S + s];
    if (kp >= 0 && kp <= qmax && (window == 0 || qmin - kp < window))
      live[1 + s / TILE] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (live[1 + i]) live[1 + n++] = i;
    live[0] = n;
  }
  __syncthreads();
  const int n_live = live[0];

  // issue the copies of live tile `it` into ring stage it % STAGES
  auto issue = [&](int it) {
    if (it < n_live) {
      const int stg = it % C::STAGES, s0 = live[1 + it] * TILE;
      __nv_bfloat16* kd = Ks + stg * TILE * ST;
      __nv_bfloat16* vd = Vs + stg * TILE * ST;
#pragma unroll 4
      for (int i = tid; i < TILE * HD / 8; i += THREADS) {
        const int j = i / (HD / 8), c = (i % (HD / 8)) * 8, s = s0 + j;
        const int bytes = s < S ? 16 : 0;
        const size_t off =
            (((size_t)b * S + (s < S ? s : 0)) * Kv + kvh) * HD + c;
        cp_async16(kd + j * ST + c, k + off, bytes);
        cp_async16(vd + j * ST + c, v + off, bytes);
      }
      if (tid < TILE) {
        const int s = s0 + tid;
        cp_async4(Kp + stg * TILE + tid,
                  k_pos + (size_t)b * S + (s < S ? s : 0), s < S ? 4 : 0);
      }
    }
    cp_async_commit();                            // empty groups keep count
  };

  // q's A fragments (16 rows x HD), k-step kk = dims 16 kk .. + 15
  uint32_t qa[C::KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < C::KSTEPS; ++kk)
    ldsm_x4(qa[kk], Qs + (lane % 16) * ST + kk * 16 + (lane / 16) * 8);

  // PV accumulators: warp w owns the 8-column slices w, w + 8, .. of HD
  float acc[C::SLICES][4];
#pragma unroll
  for (int u = 0; u < C::SLICES; ++u)
    acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0f;

  for (int it = 0; it < C::STAGES - 1; ++it) issue(it);
  for (int it = 0; it < n_live; ++it) {
    issue(it + C::STAGES - 1);
    cp_async_wait<C::STAGES - 1>();
    __syncthreads();
    const int stg = it % C::STAGES, s0 = live[1 + it] * TILE;
    const __nv_bfloat16* kt = Ks + stg * TILE * ST;
    const __nv_bfloat16* vt = Vs + stg * TILE * ST;
    const int* kpt = Kp + stg * TILE;

    // scores of the warp's NT groups of 8 keys (key 8 (warp + WARPS n) +
    // ..): c = q . k^T on the tensor cores, one accumulator per group
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      const int key0 = 8 * (warp + WARPS * n);
      const __nv_bfloat16* kr =
          kt + (key0 + lane % 8) * ST + ((lane / 8) % 2) * 8;
      uint32_t kb[C::KSTEPS][2];
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) ldsm_x2(kb[kk], kr + kk * 16);
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) mma_bf16(c, qa[kk], kb[kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g4 + 8 * (i / 2), j = key0 + 2 * q4 + i % 2;
        if (r < nr) {
          const int s = s0 + j, kp = kpt[j], qp = Qp[r];
          const bool ok = s < S && kp >= 0 && kp <= qp &&
                          (window == 0 || qp - kp < window);
          Sc[r * TILE + j] = ok ? c[i] * scale : NEG_INF;
          Ok[r * TILE + j] = ok;
        }
      }
    }
    __syncthreads();

    // online softmax: a warp per row, lane holds keys lane + 32 u; p goes
    // to shared memory as bf16
    for (int r = warp; r < nr; r += WARPS) {
      const float m_old = Mr[r];
      float sv[C::PER_LANE];
      float m_new = NEG_INF;
#pragma unroll
      for (int u = 0; u < C::PER_LANE; ++u) {
        sv[u] = Sc[r * TILE + lane + 32 * u];
        m_new = fmaxf(m_new, sv[u]);
      }
      for (int o = 16; o > 0; o /= 2)
        m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, o));
      m_new = fmaxf(m_old, m_new);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < C::PER_LANE; ++u) {
        const float e =
            Ok[r * TILE + lane + 32 * u] ? expf(sv[u] - m_new) : 0.0f;
        sum += e;
        Ps[r * PST + lane + 32 * u] = __float2bfloat16_rn(e);
      }
      for (int o = 16; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Lr[r] = Lr[r] * alpha + sum;
        Mr[r] = m_new;
        Al[r] = alpha;
      }
    }
    __syncthreads();

    {  // PV of this tile for the warp's column slices, then the rescale
      constexpr int PSTEPS = TILE / 16;
      uint32_t pa[PSTEPS][4];
#pragma unroll
      for (int ks = 0; ks < PSTEPS; ++ks)
        ldsm_x4(pa[ks], Ps + (lane % 16) * PST + ks * 16 + (lane / 16) * 8);
      const float al_lo = Al[g4], al_hi = Al[g4 + 8];
#pragma unroll
      for (int u = 0; u < C::SLICES; ++u) {
        const int col = 8 * (warp + WARPS * u);
        if (col < HD) {
          uint32_t vb[PSTEPS][2];
#pragma unroll
          for (int ks = 0; ks < PSTEPS; ++ks)
            ldsm_x2_trans(vb[ks], vt + (ks * 16 + lane % 16) * ST + col);
          float pv[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f},
                            {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int ks = 0; ks < PSTEPS; ++ks) mma_bf16(pv[ks % 2], pa[ks], vb[ks]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[u][i] = acc[u][i] * (i < 2 ? al_lo : al_hi) +
                        (pv[0][i] + pv[1][i]);
        }
      }
    }
    __syncthreads();
  }

  // rows g4 and g4 + 8, columns col + 2 q4 (+ 1)
#pragma unroll
  for (int u = 0; u < C::SLICES; ++u) {
    const int col = 8 * (warp + WARPS * u);
    if (col >= HD) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g4 + 8 * h;
      if (r >= nr) continue;
      const int tq = (r0 + r) / G, head = kvh * G + (r0 + r) % G;
      const float l = Lr[r];
      const float inv = fmaxf(l, 1e-20f);
      const float o0 = l > 0.0f ? acc[u][2 * h] / inv : 0.0f;
      const float o1 = l > 0.0f ? acc[u][2 * h + 1] / inv : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((size_t)b * T + tq) * H + head) * HD + col + 2 * q4) =
          __floats2bfloat162_rn(o0, o1);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, void* out, int B, int T, int H, int Kv, int S,
           float scale, int window, cudaStream_t stream) {
  const Layout<HD> lay((S + Cfg<HD>::TILE - 1) / Cfg<HD>::TILE);
  static int allowed[32] = {0};                // bytes set, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32 || lay.total > allowed[dev]) {
    cudaFuncSetAttribute(batch_attention_kernel<HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         lay.total);
    if (dev < 32) allowed[dev] = lay.total;
  }
  const int row_blocks = ((H / Kv) * T + MAX_ROWS - 1) / MAX_ROWS;
  dim3 grid(Kv, B, row_blocks);
  batch_attention_kernel<HD><<<grid, THREADS, lay.total, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)q_pos, (const int*)k_pos,
      (__nv_bfloat16*)out, T, H, Kv, S, scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, H, hd) bf16; k/v (B, S, Kv, hd) bf16; q_pos (B, T) i32; k_pos
// (B, S) i32; out (B, T, H, hd) bf16; all contiguous.  hd a multiple of 32,
// at most 256; H a multiple of Kv.
// Returns cudaGetLastError() after the launch.
extern "C" int batch_attention_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* k_pos, void* out, int B,
                                      int T, int H, int Kv, int S, int hd,
                                      float scale, int window, void* stream) {
  if (Kv < 1 || H % Kv) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define BATCH_ATTENTION_HD(D) \
  case D:                     \
    return launch<D>(q, k, v, q_pos, k_pos, out, B, T, H, Kv, S, scale, window, st);
  switch (hd) {
    BATCH_ATTENTION_HD(32)
    BATCH_ATTENTION_HD(64)
    BATCH_ATTENTION_HD(96)
    BATCH_ATTENTION_HD(128)
    BATCH_ATTENTION_HD(160)
    BATCH_ATTENTION_HD(192)
    BATCH_ATTENTION_HD(224)
    BATCH_ATTENTION_HD(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BATCH_ATTENTION_HD
}
