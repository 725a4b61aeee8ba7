// Kernel paged_decode: fused paged-decode attention over the paged KV pool.
//
// Replaces the Pallas kernel repro/kernels/paged_decode/kernel.py
// (_decode_kernel / paged_decode_pallas).  One block per (KV head h, slot
// b) computes, for the slot's C*G query rows r = c*G + g (at most 64),
//   * the scores of every key its page table maps (entry p covers logical
//     positions p*ps .. p*ps + ps - 1 at physical page tables[b, p]) in f32
//     times `scale`, against K dequantized as repro.core.quant.dequantize_kv
//     does (the fp8 payload times its per-(position, head) f32 scale,
//     rounded to bf16), masking a key unless 0 <= pos <= length and
//     (logical < start or the key lies in row r's own span
//     [start + c*stride, + stride)); masked scores are -2e38,
//   * an online softmax whose p is rounded to bf16 for the PV product (V
//     dequantized as K), as the Pallas kernel does,
// and writes acc / l, or 0 for a row with no valid key.  Unmapped entries
// point at the sentinel page, the pool's last, whose pos is always -1: the
// block skips keys that only the sentinel holds.
//
// What bounds it on the H100: bytes.  A decode step reads every mapped K/V
// position once (fp8: 2 * Kv * hd bytes per position, plus the scales and
// pos) and does ~4 operations per byte.  The design, after
// batch_attention.cu:
//   * The query rows are NT = 1, 2 or 4 m16 tiles (C*G <= 16, 32, 64).  The
//     block's warps form key groups of NT warps, one warp per row tile; the
//     groups split the slot's keys in chunks of 32 positions.  A group
//     stages each of its chunks ONCE (the K/V read is what bounds decode)
//     and each of its warps scores that chunk against its own row tile,
//     with its own online softmax state (m, l and the f32 accumulator in
//     registers), so a warp holds one tile's state however many tiles there
//     are.  The block combines the groups' states once at the end.  Nothing
//     but a group barrier (a named barrier of NT warps; a warp sync at NT =
//     1) and the final combine waits on another warp.
//   * Each group copies its own chunks with 16-byte cp.async (a key's K and
//     V rows, its warps taking every NT-th 16-byte piece, and 4-byte copies
//     of its scales and pos) into a 2-stage ring of its own, so the next
//     chunk is in flight while one is scored.
//   * QK^T and PV run on the tensor cores (bf16 mma.sync.m16n8k16, f32
//     accumulation; a warp's 16 query rows are one m16 tile).  K and V are
//     dequantized in registers while their B fragments are built: the
//     contraction over head dims is taken in a permuted order (thread
//     quarter q4 holds dims q4 * hd / 4 .. + hd / 4 - 1, 4 per k-step), so a
//     thread's K bytes of a key are contiguous 16-byte loads, and the PV
//     output columns are permuted (column n of n8 tile u of a 32-dim group
//     is dim 4n + u), so a thread reads 4 contiguous V bytes per key; the
//     scores' C fragments are PV's A fragments (p never leaves registers).
//   * The kernel is a template on hd (64, 128, 256) and the payload type,
//     so every loop over hd unrolls with no guard.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;      // query rows of one m16 tile (one warp's)
constexpr int MAX_TILES = 4;
constexpr int MAX_CG = TILE * MAX_TILES;
constexpr int MAX_WARPS = 8;  // a warp holds ~HD/2 + HD/4 f32 of state
constexpr int CHUNK = 32;     // keys a group takes at a time
constexpr int STAGES = 2;
constexpr float NEG_INF = -2.0e38f;
constexpr int RING_BUDGET = 200 * 1024;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two e4m3 bytes (the low 16 bits of w >> shift), each times s, rounded to
// bf16 and packed (dequantize_kv: f32 payload x scale, cast)
__device__ __forceinline__ uint32_t deq2(uint32_t w, int shift, float s) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)((w >> shift) & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return pack_bf16(__fmul_rn(f.x, s), __fmul_rn(f.y, s));
}

// all NT warps of key group `id - 1` wait here (named barrier `id`)
template <int NT>
__device__ __forceinline__ void group_sync(int id) {
  if constexpr (NT == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NT * 32) : "memory");
  }
}

// The kernel's shape for head dim HD, payload bytes EB (1: e4m3 with
// scales, 2: bf16) and NT row tiles: a group's ring stage holds a chunk's K
// rows, V rows (each padded by 16 bytes), pos and scales; the key groups
// per block are as many as fit a 2-stage ring each in RING_BUDGET and
// MAX_WARPS warps in all.
template <int HD, int EB, int NT>
struct Cfg {
  static constexpr bool QUANT = EB == 1;
  static constexpr int RB = HD * EB;              // payload bytes of a row
  static constexpr int ST = RB + 16;              // padded row stride
  static constexpr int PIECES = RB / 16;          // 16-byte copies per row
  static constexpr int K_OFF = 0, V_OFF = CHUNK * ST, POS_OFF = 2 * CHUNK * ST;
  static constexpr int KS_OFF = POS_OFF + CHUNK * 4;
  static constexpr int VS_OFF = KS_OFF + CHUNK * 4;
  static constexpr int STAGE = VS_OFF + (QUANT ? CHUNK * 4 : 0);
  static constexpr int KG_RING = 8 * STAGES * STAGE <= RING_BUDGET   ? 8
                                 : 4 * STAGES * STAGE <= RING_BUDGET ? 4
                                                                      : 2;
  static constexpr int KG = KG_RING * NT <= MAX_WARPS ? KG_RING
                                                      : MAX_WARPS / NT;
  static constexpr int WARPS = KG * NT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RING = KG * STAGES * STAGE;
  static constexpr int KSTEPS = HD / 16;          // QK^T k-steps
  static constexpr int DPT = HD / 4;              // dims a thread quarter holds
  static constexpr int GROUPS = HD / 32;          // PV 32-dim column groups
  // the end-of-loop combine reuses the ring (grown where it is smaller):
  // WARPS x 16 rows x (HD + 1) f32 (a padded row: the fragment stores hit
  // distinct banks)
  static constexpr int RS = HD + 1;
  static constexpr int RED = WARPS * TILE * RS * 4;
  static constexpr int SCRATCH = RING > RED ? RING : RED;
  static_assert(HD % 64 == 0, "hd 64, 128 or 256");
  static_assert(PIECES % NT == 0, "a group's warps split a row's pieces");
};

template <int HD, int EB, int NT>
struct Layout {
  using C = Cfg<HD, EB, NT>;
  int tab, live, m, l, total;
  __host__ __device__ Layout(int P, int n_chunks) {
    tab = C::SCRATCH;
    live = tab + P * 4;
    m = live + (n_chunks + 1) * 4;
    l = m + C::WARPS * TILE * 4;
    total = l + C::WARPS * TILE * 4;
  }
};

template <int HD, int EB, int NT>
__global__ void __launch_bounds__(Cfg<HD, EB, NT>::THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const uint8_t* __restrict__ kp,
                    const uint8_t* __restrict__ vp,
                    const int* __restrict__ pos,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    const int* __restrict__ starts,
                    __nv_bfloat16* __restrict__ out, int Kv, int CG, int P,
                    int ps, int group, int stride, int sentinel,
                    float scale) {
  using C = Cfg<HD, EB, NT>;
  constexpr int KG = C::KG, ST = C::ST, DPT = C::DPT;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tile = warp % NT, kg = warp / NT;     // row tile, key group
  const int g = lane / 4, q4 = lane % 4;          // mma fragment coordinates
  const int n_keys = P * ps, n_chunks = (n_keys + CHUNK - 1) / CHUNK;
  const Layout<HD, EB, NT> lay(P, n_chunks);
  extern __shared__ __align__(16) uint8_t smem[];
  int* Tab = reinterpret_cast<int*>(smem + lay.tab);
  int* Live = reinterpret_cast<int*>(smem + lay.live);   // [n, chunks..]
  float* Ms = reinterpret_cast<float*>(smem + lay.m);    // [warp][row]
  float* Ls = reinterpret_cast<float*>(smem + lay.l);

  for (int i = tid; i < P; i += C::THREADS) Tab[i] = tables[(size_t)b * P + i];

  // q's A fragments, in the permuted order: k-step kk, registers 0 / 2 hold
  // dims q4 * DPT + 4 kk + {0, 1} / {2, 3} of the tile's row g, 1 / 3 those
  // of g + 8 (rows 16 tile + g and + 8 of the slot's C*G)
  const int row0 = TILE * tile + g;
  uint32_t qa[C::KSTEPS][4];
  {
    const __nv_bfloat16* qb = q + (size_t)(b * Kv + h) * CG * HD + q4 * DPT;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh;
      uint4 w[DPT / 8];
#pragma unroll
      for (int j = 0; j < DPT / 8; ++j)
        w[j] = r < CG ? *reinterpret_cast<const uint4*>(qb + (size_t)r * HD +
                                                        8 * j)
                      : make_uint4(0, 0, 0, 0);
      const uint32_t* ww = reinterpret_cast<const uint32_t*>(w);
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        qa[kk][hh] = ww[2 * kk];
        qa[kk][2 + hh] = ww[2 * kk + 1];
      }
    }
  }
  __syncthreads();

  // the chunks some page of which is not the sentinel, in order
  if (warp == 0) {
    int n = 0;
    for (int c0 = 0; c0 < n_chunks; c0 += 32) {
      const int c = c0 + lane;
      bool live = false;
      if (c < n_chunks) {
        const int p1 = min(P - 1, (c * CHUNK + CHUNK - 1) / ps);
        for (int p = c * CHUNK / ps; p <= p1; ++p) live |= Tab[p] != sentinel;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) Live[1 + n + __popc(mask & ((1u << lane) - 1))] = c;
      n += __popc(mask);
    }
    if (lane == 0) Live[0] = n;
  }
  __syncthreads();
  const int n_live = Live[0];
  const int mine = n_live > kg ? (n_live - kg + KG - 1) / KG : 0;
  const int length = lengths[b], start = starts[b];
  uint8_t* ring = smem + kg * STAGES * C::STAGE;

  // copy the group's i-th chunk (live chunk kg + KG i) into stage i % 2:
  // this warp's share of it (every NT-th 16-byte piece of the K/V rows;
  // pos and scales by the tile-0 warp)
  auto issue = [&](int i) {
    if (i < mine) {
      const int c = Live[1 + kg + KG * i];
      uint8_t* st = ring + (i % STAGES) * C::STAGE;
      // lane = key: its physical row (row 0 past the table: zero-filled)
      const int logical = c * CHUNK + lane;
      const bool ok = logical < n_keys;
      const size_t row =
          ok ? (size_t)Tab[logical / ps] * ps + logical % ps : 0;
      const size_t rh = row * Kv + h;
      if (tile == 0) {
        cp_async4(st + C::POS_OFF + 4 * lane, pos + row, ok ? 4 : 0);
        if constexpr (C::QUANT) {
          cp_async4(st + C::KS_OFF + 4 * lane, ks + rh, ok ? 4 : 0);
          cp_async4(st + C::VS_OFF + 4 * lane, vs + rh, ok ? 4 : 0);
        }
      }
#pragma unroll
      for (int jj = 0; jj < C::PIECES / NT; ++jj) {
        const int j = tile + NT * jj;
        const int i2 = lane + 32 * j, key = i2 / C::PIECES;
        const int piece = i2 % C::PIECES;
        const size_t krh = (size_t)__shfl_sync(
            0xffffffffu, (unsigned long long)rh, key);
        const int kok = __shfl_sync(0xffffffffu, (int)ok, key);
        const size_t src = krh * C::RB + 16 * piece;
        cp_async16(st + C::K_OFF + key * ST + 16 * piece, kp + src,
                   kok ? 16 : 0);
        cp_async16(st + C::V_OFF + key * ST + 16 * piece, vp + src,
                   kok ? 16 : 0);
      }
    }
    cp_async_commit();                            // empty groups keep count
  };

  // acc[u][i]: row g + 8 (i / 2), dim 32 (u / 4) + 4 (2 q4 + i % 2) + u % 4
  float acc[HD / 8][4];
#pragma unroll
  for (int u = 0; u < HD / 8; ++u)
    acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
  // the first key of each row's own span
  const int own0 = start + (row0 / group) * stride;
  const int own1 = start + ((row0 + 8) / group) * stride;

  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    issue(i + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    group_sync<NT>(1 + kg);                       // the group's copies land
    const uint8_t* st = ring + (i % STAGES) * C::STAGE;
    const uint8_t* kt = st + C::K_OFF;
    const uint8_t* vt = st + C::V_OFF;
    const int* pk = reinterpret_cast<const int*>(st + C::POS_OFF);
    const float* ksc = reinterpret_cast<const float*>(st + C::KS_OFF);
    const float* vsc = reinterpret_cast<const float*>(st + C::VS_OFF);
    const int base = Live[1 + kg + KG * i] * CHUNK;

    // scores of the chunk's four groups of 8 keys: key 8 t + g's B fragment
    float s[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint8_t* kr = kt + (8 * t + g) * ST + q4 * DPT * EB;
      uint32_t kb[C::KSTEPS][2];
      if constexpr (C::QUANT) {
        const float sk = ksc[8 * t + g];
#pragma unroll
        for (int j = 0; j < DPT / 16; ++j) {      // 16 bytes: k-steps 4j..
          const uint4 v = *reinterpret_cast<const uint4*>(kr + 16 * j);
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            kb[4 * j + m][0] = deq2(w[m], 0, sk);
            kb[4 * j + m][1] = deq2(w[m], 16, sk);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < DPT / 8; ++j) {       // 16 bytes: k-steps 2j..
          const uint4 v = *reinterpret_cast<const uint4*>(kr + 16 * j);
          kb[2 * j][0] = v.x;
          kb[2 * j][1] = v.y;
          kb[2 * j + 1][0] = v.z;
          kb[2 * j + 1][1] = v.w;
        }
      }
      float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk)
        mma_bf16(c4, qa[kk], kb[kk][0], kb[kk][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * t + 2 * q4 + e % 2, logical = base + key;
        const int own = e < 2 ? own0 : own1;
        const int pv = pk[key];
        const bool ok = logical < n_keys && pv >= 0 && pv <= length &&
                        (logical < start ||
                         (logical >= own && logical < own + stride));
        s[t][e] = ok ? c4[e] * scale : NEG_INF;
      }
    }

    // online softmax of rows g (e < 2) and g + 8 over the chunk; the quad
    // of lanes sharing g holds a row's 32 keys
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG_INF;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        mx = fmaxf(mx, fmaxf(s[t][2 * hh], s[t][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx);
      alpha[hh] = expf(m_r[hh] - m_new);
      m_r[hh] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float p = s[t][e] > NEG_INF ? expf(s[t][e] - m_new) : 0.0f;
          s[t][e] = p;
          sum += p;
        }
      l_r[hh] = l_r[hh] * alpha[hh] + sum;
    }
    // p rounded to bf16: the scores' C fragments are PV's A fragments
    uint32_t pa[2][4];
#pragma unroll
    for (int ks2 = 0; ks2 < 2; ++ks2) {
      pa[ks2][0] = pack_bf16(s[2 * ks2][0], s[2 * ks2][1]);
      pa[ks2][1] = pack_bf16(s[2 * ks2][2], s[2 * ks2][3]);
      pa[ks2][2] = pack_bf16(s[2 * ks2 + 1][0], s[2 * ks2 + 1][1]);
      pa[ks2][3] = pack_bf16(s[2 * ks2 + 1][2], s[2 * ks2 + 1][3]);
    }
#pragma unroll
    for (int u = 0; u < HD / 8; ++u) {
      acc[u][0] *= alpha[0];
      acc[u][1] *= alpha[0];
      acc[u][2] *= alpha[1];
      acc[u][3] *= alpha[1];
    }

    // PV: n8 tile u = 4 G + u2 of the 32-dim group G, column g = dim
    // 32 G + 4 g + u2; a thread reads keys k0, k0 + 1, k0 + 8, k0 + 9
#pragma unroll
    for (int ks2 = 0; ks2 < 2; ++ks2) {
      const int k0 = 16 * ks2 + 2 * q4;
      const int kr[4] = {k0, k0 + 1, k0 + 8, k0 + 9};
      float sv[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if constexpr (C::QUANT) {
#pragma unroll
        for (int a = 0; a < 4; ++a) sv[a] = vsc[kr[a]];
      }
#pragma unroll
      for (int G = 0; G < C::GROUPS; ++G) {
        // lo[a] / hi[a]: dims 4g + {0, 1} / {2, 3} of key kr[a], bf16 pairs
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const uint8_t* vr = vt + kr[a] * ST + (32 * G + 4 * g) * EB;
          if constexpr (C::QUANT) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(vr);
            lo[a] = deq2(w, 0, sv[a]);
            hi[a] = deq2(w, 16, sv[a]);
          } else {
            const uint2 w = *reinterpret_cast<const uint2*>(vr);
            lo[a] = w.x;
            hi[a] = w.y;
          }
        }
        // (key kr[0], kr[1]) and (kr[2], kr[3]) pairs at one dim
        mma_bf16(acc[4 * G + 0], pa[ks2], __byte_perm(lo[0], lo[1], 0x5410),
                 __byte_perm(lo[2], lo[3], 0x5410));
        mma_bf16(acc[4 * G + 1], pa[ks2], __byte_perm(lo[0], lo[1], 0x7632),
                 __byte_perm(lo[2], lo[3], 0x7632));
        mma_bf16(acc[4 * G + 2], pa[ks2], __byte_perm(hi[0], hi[1], 0x5410),
                 __byte_perm(hi[2], hi[3], 0x5410));
        mma_bf16(acc[4 * G + 3], pa[ks2], __byte_perm(hi[0], hi[1], 0x7632),
                 __byte_perm(hi[2], hi[3], 0x7632));
      }
    }
    group_sync<NT>(1 + kg);                       // the stage may be reused
  }
  cp_async_wait<0>();

  // combine the groups' states: the ring becomes [warp][row][dim] f32, warp
  // kg * NT + tile holding rows 16 tile .. + 15
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (q4 == 0) {
      Ms[warp * TILE + g + 8 * hh] = m_r[hh];
      Ls[warp * TILE + g + 8 * hh] = l;
    }
  }
#pragma unroll
  for (int u = 0; u < HD / 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e / 2);
      const int d = 32 * (u / 4) + 4 * (2 * q4 + e % 2) + u % 4;
      red[(warp * TILE + r) * C::RS + d] = acc[u][e];
    }
  __syncthreads();
  __nv_bfloat16* ob = out + (size_t)(b * Kv + h) * CG * HD;
  for (int i = tid; i < CG * HD; i += C::THREADS) {
    const int r = i / HD, d = i % HD;
    // row r's state in group w: warp w NT + r / 16, its row r % 16, so
    // entry (w NT + r / 16) 16 + r % 16 = w NT 16 + r
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < KG; ++w) mx = fmaxf(mx, Ms[w * NT * TILE + r]);
    float l = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < KG; ++w) {
      const float f = expf(Ms[w * NT * TILE + r] - mx);
      l += Ls[w * NT * TILE + r] * f;
      o += red[(w * NT * TILE + r) * C::RS + d] * f;
    }
    ob[i] = __float2bfloat16_rn(l > 0.0f ? o / fmaxf(l, 1e-20f) : 0.0f);
  }
}

template <int HD, int EB, int NT>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* lengths, const void* starts, void* out, int B, int Kv,
           int CG, int P, int ps, int group, int stride, int sentinel,
           float scale, cudaStream_t st) {
  using C = Cfg<HD, EB, NT>;
  const Layout<HD, EB, NT> lay(P, (P * ps + CHUNK - 1) / CHUNK);
  static int allowed[32] = {0};                 // bytes set, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32 || lay.total > allowed[dev]) {
    cudaFuncSetAttribute(paged_decode_kernel<HD, EB, NT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         lay.total);
    if (dev < 32) allowed[dev] = lay.total;
  }
  paged_decode_kernel<HD, EB, NT>
      <<<dim3(Kv, B), C::THREADS, lay.total, st>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)k, (const uint8_t*)v,
      (const int*)pos, (const float*)k_scale, (const float*)v_scale,
      (const int*)tables, (const int*)lengths, (const int*)starts,
      (__nv_bfloat16*)out, Kv, CG, P, ps, group, stride, sentinel, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Kv, CG, hd) bf16; k/v (NPos, Kv, hd) bf16 or e4m3 bytes (quantized
// != 0, then k_scale/v_scale (NPos, Kv) f32); pos (NPos) i32, the last page
// (NPos / ps - 1) the sentinel; tables (B, P) i32; lengths/starts (B) i32;
// out (B, Kv, CG, hd) bf16; all contiguous, 16-byte aligned.  hd 64, 128 or
// 256; 1 <= CG <= 64 (1, 2 or 4 row tiles: 33..48 rows run 4, the last
// one empty).  Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pos,
                                   const void* k_scale, const void* v_scale,
                                   const void* tables, const void* lengths,
                                   const void* starts, void* out, int B,
                                   int Kv, int CG, int hd, int P, int ps,
                                   int group, int stride, int n_pos,
                                   float scale, int quantized, void* stream) {
  if (CG > MAX_CG || CG < 1 || ps < 1 || group < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Kv == 0) return 0;
  const int sentinel = n_pos / ps - 1;
  cudaStream_t st = (cudaStream_t)stream;
#define PAGED_DECODE_LAUNCH(D, EB, NT)                                       \
  launch<D, EB, NT>(q, k, v, pos, EB == 1 ? k_scale : nullptr,               \
                    EB == 1 ? v_scale : nullptr, tables, lengths, starts,    \
                    out, B, Kv, CG, P, ps, group, stride, sentinel, scale,   \
                    st)
#define PAGED_DECODE_TILES(D, EB)                                            \
  (n_tiles == 1   ? PAGED_DECODE_LAUNCH(D, EB, 1)                            \
   : n_tiles == 2 ? PAGED_DECODE_LAUNCH(D, EB, 2)                            \
                  : PAGED_DECODE_LAUNCH(D, EB, 4))
#define PAGED_DECODE_HD(D)                                                   \
  case D:                                                                    \
    return quantized ? PAGED_DECODE_TILES(D, 1) : PAGED_DECODE_TILES(D, 2);
  const int n_tiles = (CG + TILE - 1) / TILE;
  switch (hd) {
    PAGED_DECODE_HD(64)
    PAGED_DECODE_HD(128)
    PAGED_DECODE_HD(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAGED_DECODE_HD
#undef PAGED_DECODE_TILES
#undef PAGED_DECODE_LAUNCH
}
