// Kernel batch_attention: GQA attention of a batch of query rows over a
// dense per-row KV cache, the decode attention of the contiguous slot-pool
// and shared-index layouts under use_attention_kernel.
//
// Replaces the Pallas kernel repro/kernels/batch_attention/kernel.py
// (_attn_kernel / batch_attention_pallas), with K and V either bf16 or an
// fp8 cache's e4m3 payload and per-(position, head) f32 scales, which the
// kernel turns into bf16 exactly as repro.core.quant.dequantize_kv does
// (the f32 payload times its scale, rounded to nearest).  One block of 8
// or 16 warps per (KV head, key split, batch row, block of at most 16 query
// rows).  A block's rows are r = t * G + g (query position t, head g of the
// group), read straight from q's (B, T, H, hd) layout and written to out's
// (B, T, H * hd); the block loads its rows' q_pos itself.  It walks its
// split's range of the cache in tiles of 128 positions (64 above hd = 128);
// for each tile it
//   * scores every (row, key) pair in f32 times `scale`, masking a key
//     unless 0 <= k_pos <= q_pos (and q_pos - k_pos < window when a window
//     is set); masked scores are -2e38,
//   * folds the tile into the online softmax (m, l in shared memory, the
//     f32 accumulator in registers), with p rounded to bf16 for the PV
//     product as the Pallas kernel rounds it to V's dtype.
// With one split the block writes acc / max(l, 1e-20), or 0 for a row with
// no valid key, as bf16.  With several (flash-decoding) each block writes
// its rows' unnormalised (m, l, acc) in f32 to scratch, and the last block
// of the (KV head, batch row, row block) to arrive -- an int32 counter,
// which it resets, tells it -- combines the partials in split order:
// M = max m_i, L = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) /
// max(L, 1e-20), 0 where L = 0.  No float atomics: the output is the same
// bit for bit from call to call.  Where the Pallas grid carried (m, l, acc)
// across sequential S-blocks in VMEM scratch, the loop over tiles runs
// inside the block and the splits run side by side.
//
// What bounds it on the H100: bytes.  Decode attention reads the valid part
// of the cache (at llama3-8b's S = 4112, B = 4: 67 MB of bf16 K and V,
// ~20 us at 3.35 TB/s) and does ~4 operations per byte.  The design keeps
// the bytes in flight on every SM and the arithmetic off the critical path:
//   * the host's plan (kernels/batch_attention/ops.py) splits the keys so
//     that the grid fills about one wave of the SMs: a grid of (KV heads x
//     rows x row blocks) alone launches 4-64 blocks at the LM zoo's decode
//     shapes, each walking all 4112 keys; where it already fills the card
//     (OneRec's decode: 128 blocks) the plan keeps one split;
//   * K/V tiles arrive by 16-byte cp.async, neighbouring threads on
//     neighbouring addresses, into a 2-stage ring: the next tile is in
//     flight while one is scored (the key positions, and an fp8 cache's
//     scales, come along by 4-byte cp.async), and the range's first tile
//     is in flight before the scan below has marked it live.  A bf16 tile
//     is used where it lands; an fp8 tile (half the bytes) is dequantized
//     once into a bf16 tile in shared memory;
//   * before the loop the block marks the tiles of its range that hold a
//     key some row of it may see (k_pos >= 0, <= the largest q_pos, inside
//     the window of the smallest) and walks only those: a tile of empty or
//     masked keys changes nothing (its p are 0 and its running max is the
//     old one).  The positions, the query rows and their q_pos are read in
//     one round trip;
//   * QK^T and PV run on the tensor cores (bf16 mma.sync.m16n8k16, f32
//     accumulation; the block's <= 16 rows are one m16 tile): warp w scores
//     its groups of 8 keys against q's fragments held in registers, a warp
//     per row runs the softmax with shuffles and stores p as bf16 (exact: p
//     is rounded to bf16 anyway), and warp w computes PV for its 8-column
//     slices of hd.  The 8 rows an ldmatrix reads hit 8 distinct bank
//     groups: a bf16 ring row's 16-byte chunks are XOR-swizzled by row
//     (hd a multiple of 64), other shared bf16 rows padded by 16 bytes;
//   * the kernel is a template on hd and the payload, so every loop over hd
//     is unrolled with no guard and the fragment loads of a tile issue
//     before its MMAs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 16;
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

// The kernel's shape for head dim HD and payload bytes EB (2: bf16, 1:
// e4m3 with scales): 128-key tiles up to hd = 128, 64-key tiles above, in
// a 2-stage ring (on an H100 3 and 4 stages ran no faster).  A ring stage
// holds a tile's K and V payload (e4m3 rows unpadded, read once by the
// dequantization), its positions and, for e4m3, its scales; an e4m3 block
// also holds one dequantized bf16 tile (rows padded).  q and p rows are
// padded.
template <int HD, int EB>
struct Cfg {
  static constexpr bool QUANT = EB == 1;
  static constexpr int TILE = HD <= 128 ? 128 : 64;
  // a warp per group of 8 keys of a 128-key tile above hd = 64 (more warps
  // hide more of each phase's latency: on an H100 the e4m3 tile's
  // dequantization ran faster so, bf16 no slower); 8 warps otherwise (up to
  // hd = 64 two blocks of 8 fit an SM's registers)
  static constexpr int WARPS = TILE == 128 && HD > 64 ? 16 : 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int STAGES = 2;
  static constexpr int ST = HD + 8;             // padded bf16 row
  static constexpr int PST = TILE + 8;          // padded p row, bf16
  // a bf16 ring row of hd a multiple of 64 is unpadded, its 16-byte
  // chunks XOR-swizzled by row % 8 (ldmatrix stays free of bank
  // conflicts, and cp.async fills whole 128-byte lines: rows padded by 16
  // bytes stream slower, scripts/stream_kv.py); other bf16 rows are padded
  static constexpr bool SWZ = !QUANT && HD % 64 == 0;
  static constexpr int RB = QUANT ? HD : SWZ ? HD * 2 : ST * 2;  // bytes
  static constexpr int RS = RB / 2;             // bf16 ring row, elements
  static constexpr int K_OFF = 0, V_OFF = TILE * RB, KP_OFF = 2 * TILE * RB;
  static constexpr int KS_OFF = KP_OFF + TILE * 4;
  static constexpr int VS_OFF = KS_OFF + TILE * 4;
  static constexpr int STAGE = QUANT ? VS_OFF + TILE * 4 : KS_OFF;
  static constexpr int KSTEPS = HD / 16;        // QK^T k-steps
  static constexpr int NT = TILE / 8 / WARPS;   // key n8-tiles a warp scores
  static constexpr int SLICES = (HD / 8 + WARPS - 1) / WARPS;  // PV n8-tiles
  static constexpr int PER_LANE = TILE / 32;    // softmax keys a lane holds
  // a split's partial: acc (MAX_ROWS x HD), then m and l (MAX_ROWS each)
  static constexpr int REC = MAX_ROWS * (HD + 2);
};

// Byte offsets of the shared-memory regions (host and device agree); `tps`
// is the tiles of a split's range.
template <int HD, int EB>
struct Layout {
  using C = Cfg<HD, EB>;
  int ring, kb, q, sc, ok, p, m, l, al, qp, flag, live, total;
  __host__ __device__ explicit Layout(int tps) {
    ring = 0;
    kb = ring + C::STAGES * C::STAGE;
    q = kb + (C::QUANT ? 2 * C::TILE * C::ST * 2 : 0);
    sc = q + MAX_ROWS * C::ST * 2;
    ok = sc + MAX_ROWS * C::TILE * 4;
    p = ok + MAX_ROWS * C::TILE;
    m = p + MAX_ROWS * C::PST * 2;
    l = m + MAX_ROWS * 4;
    al = l + MAX_ROWS * 4;
    qp = al + MAX_ROWS * 4;
    flag = qp + MAX_ROWS * 4;
    live = flag + ((tps + 15) / 16) * 16;
    total = live + (tps + 1) * 4;
  }
};

template <int HD, int EB>
__global__ void __launch_bounds__(Cfg<HD, EB>::THREADS)
batch_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const uint8_t* __restrict__ k,
                       const uint8_t* __restrict__ v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counters,
                       int T, int H, int Kv, int S, float scale, int window,
                       int splits, int tps) {
  using C = Cfg<HD, EB>;
  constexpr int TILE = C::TILE, ST = C::ST, PST = C::PST;
  constexpr int THREADS = C::THREADS, WARPS = C::WARPS;
  const int kvh = blockIdx.x / splits, split = blockIdx.x % splits;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, q4 = lane % 4;       // mma fragment coordinates
  const int G = H / Kv;
  const int r0 = blockIdx.z * MAX_ROWS;
  const int nr = min(MAX_ROWS, G * T - r0);
  const int n_tiles = (S + TILE - 1) / TILE;
  const int t0 = min(split * tps, n_tiles), t1 = min(t0 + tps, n_tiles);
  const Layout<HD, EB> lay(tps);
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  float* Sc = reinterpret_cast<float*>(smem + lay.sc);   // masked scores
  uint8_t* Ok = smem + lay.ok;                            // valid (row, key)
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + lay.p);
  float* Mr = reinterpret_cast<float*>(smem + lay.m);    // running max
  float* Lr = reinterpret_cast<float*>(smem + lay.l);    // running sum
  float* Al = reinterpret_cast<float*>(smem + lay.al);   // this tile's rescale
  int* Qp = reinterpret_cast<int*>(smem + lay.qp);
  uint8_t* Fl = smem + lay.flag;                         // tile t0 + i live
  int* live = reinterpret_cast<int*>(smem + lay.live);   // [n_live, tiles..]

  // copy tile `tile` into ring stage `stg`
  auto load = [&](int tile, int stg) {
    const int s0 = tile * TILE;
    uint8_t* st = smem + lay.ring + stg * C::STAGE;
    constexpr int PIECES = HD * EB / 16;            // 16-byte pieces a row
#pragma unroll 4
    for (int i = tid; i < TILE * PIECES; i += THREADS) {
      const int j = i / PIECES, c = (i % PIECES) * 16, s = s0 + j;
      const int bytes = s < S ? 16 : 0;
      const size_t off =
          (((size_t)b * S + (s < S ? s : 0)) * Kv + kvh) * (HD * EB) + c;
      const int to = j * C::RB + (C::SWZ ? ((c / 16) ^ (j & 7)) * 16 : c);
      cp_async16(st + C::K_OFF + to, k + off, bytes);
      cp_async16(st + C::V_OFF + to, v + off, bytes);
    }
    if (tid < TILE) {
      const int s = s0 + tid, ok = s < S ? 4 : 0;
      const size_t row = (size_t)b * S + (s < S ? s : 0);
      cp_async4(st + C::KP_OFF + 4 * tid, k_pos + row, ok);
      if constexpr (C::QUANT) {
        cp_async4(st + C::KS_OFF + 4 * tid, k_scale + row * Kv + kvh, ok);
        cp_async4(st + C::VS_OFF + 4 * tid, v_scale + row * Kv + kvh, ok);
      }
    }
  };
  // the range's first tile is copied before the scan below tells whether
  // it is live (it is wherever rows fill the cache from its start), so
  // its DRAM latency overlaps the scan's
  if (t0 < t1) {
    load(t0, 0);
    cp_async_commit();
  }

  for (int i = tid; i < t1 - t0; i += THREADS) Fl[i] = 0;
  __syncthreads();

  // one round trip: q row r (t_q = r / G, g = r % G) is head kvh * G + g
  // at position t_q (rows past nr, and p, start at zero); the rows' q_pos;
  // the positions of the split's range, marking the tiles holding a key
  // some row of the block may see
  const int* qpb = q_pos + (size_t)b * T;
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
    Qp[tid] = tid < nr ? qpb[(r0 + tid) / G] : -1;
    Mr[tid] = NEG_INF;
    Lr[tid] = 0.0f;
    Al[tid] = 0.0f;
  }
  {
    const int tq0 = r0 / G, tq1 = (r0 + nr - 1) / G;
    int qmin = qpb[tq0], qmax = qmin;
    for (int tq = tq0 + 1; tq <= tq1; ++tq) {
      qmin = min(qmin, qpb[tq]);
      qmax = max(qmax, qpb[tq]);
    }
    const int s_end = min(t1 * TILE, S);
    for (int s = t0 * TILE + tid; s < s_end; s += THREADS) {
      const int kp = k_pos[(size_t)b * S + s];
      if (kp >= 0 && kp <= qmax && (window == 0 || qmin - kp < window))
        Fl[s / TILE - t0] = 1;
    }
  }
  __syncthreads();
  if (warp == 0) {                        // the live tiles, in order
    int n = 0;
    for (int c0 = 0; c0 < t1 - t0; c0 += 32) {
      const bool on = c0 + lane < t1 - t0 && Fl[c0 + lane];
      const unsigned mask = __ballot_sync(0xffffffffu, on);
      if (on) live[1 + n + __popc(mask & ((1u << lane) - 1))] = t0 + c0 + lane;
      n += __popc(mask);
    }
    if (lane == 0) live[0] = n;
  }
  __syncthreads();
  const int n_live = live[0];

  // issue the copies of live tile `it` into ring stage it % STAGES
  auto issue = [&](int it) {
    if (it < n_live) load(live[1 + it], it % C::STAGES);
    cp_async_commit();                            // empty groups keep count
  };

  // q's A fragments (16 rows x HD), k-step kk = dims 16 kk .. + 15
  uint32_t qa[C::KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < C::KSTEPS; ++kk)
    ldsm_x4(qa[kk], Qs + (lane % 16) * ST + kk * 16 + (lane / 16) * 8);

  // PV accumulators: warp w owns the 8-column slices w, w + WARPS, .. of HD
  float acc[C::SLICES][4];
#pragma unroll
  for (int u = 0; u < C::SLICES; ++u)
    acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0f;

  // the first copy stands for live tile 0 if that is the range's first;
  // else it lands before stage 0 is copied again
  int first = 0;
  if (t0 < t1) {
    if (n_live > 0 && live[1] == t0) {
      first = 1;
    } else {
      cp_async_wait<0>();
      __syncthreads();
    }
  }
  for (int it = first; it < C::STAGES - 1; ++it) issue(it);
  for (int it = 0; it < n_live; ++it) {
    issue(it + C::STAGES - 1);
    cp_async_wait<C::STAGES - 1>();
    __syncthreads();
    const int s0 = live[1 + it] * TILE;
    const uint8_t* st = smem + lay.ring + (it % C::STAGES) * C::STAGE;
    const int* kpt = reinterpret_cast<const int*>(st + C::KP_OFF);
    // the bf16 K and V tiles: element (row, col) of a row-major tile with
    // row stride RS (col a multiple of 8), swizzled in the ring
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    constexpr int RS = C::QUANT ? ST : C::RS;
    auto at = [&](const __nv_bfloat16* t, int row, int col) {
      if constexpr (C::SWZ)
        return t + row * RS + (((col / 8) ^ (row & 7)) * 8);
      else
        return t + row * RS + col;
    };
    if constexpr (C::QUANT) {
      // the e4m3 K and V to the bf16 tile, 8 values a thread a step
      __nv_bfloat16* Kd = reinterpret_cast<__nv_bfloat16*>(smem + lay.kb);
      __nv_bfloat16* Vd = Kd + TILE * ST;
      const float* ksc = reinterpret_cast<const float*>(st + C::KS_OFF);
      const float* vsc = reinterpret_cast<const float*>(st + C::VS_OFF);
#pragma unroll 4
      for (int i = tid; i < TILE * HD / 8; i += THREADS) {
        const int j = i / (HD / 8), c = (i % (HD / 8)) * 8;
        const uint2 wk = *reinterpret_cast<const uint2*>(st + C::K_OFF +
                                                         j * HD + c);
        const uint2 wv = *reinterpret_cast<const uint2*>(st + C::V_OFF +
                                                         j * HD + c);
        const float sk = ksc[j], sv = vsc[j];
        *reinterpret_cast<uint4*>(Kd + j * ST + c) =
            make_uint4(deq2(wk.x, 0, sk), deq2(wk.x, 16, sk),
                       deq2(wk.y, 0, sk), deq2(wk.y, 16, sk));
        *reinterpret_cast<uint4*>(Vd + j * ST + c) =
            make_uint4(deq2(wv.x, 0, sv), deq2(wv.x, 16, sv),
                       deq2(wv.y, 0, sv), deq2(wv.y, 16, sv));
      }
      __syncthreads();
      kt = Kd;
      vt = Vd;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(st + C::K_OFF);
      vt = reinterpret_cast<const __nv_bfloat16*>(st + C::V_OFF);
    }

    // scores of the warp's NT groups of 8 keys (key 8 (warp + WARPS n) +
    // ..): c = q . k^T on the tensor cores, one accumulator per group
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      const int key0 = 8 * (warp + WARPS * n);
      uint32_t kb[C::KSTEPS][2];
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk)
        ldsm_x2(kb[kk], at(kt, key0 + lane % 8,
                           kk * 16 + ((lane / 8) % 2) * 8));
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
            ldsm_x2_trans(vb[ks], at(vt, ks * 16 + lane % 16, col));
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

  // the out row of block row r
  auto out_row = [&](int r) {
    const int tq = (r0 + r) / G, head = kvh * G + (r0 + r) % G;
    return out + (((size_t)b * T + tq) * H + head) * HD;
  };

  if (splits == 1) {
    // rows g4 and g4 + 8, columns col + 2 q4 (+ 1)
#pragma unroll
    for (int u = 0; u < C::SLICES; ++u) {
      const int col = 8 * (warp + WARPS * u);
      if (col >= HD) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g4 + 8 * h;
        if (r >= nr) continue;
        const float l = Lr[r];
        const float inv = fmaxf(l, 1e-20f);
        const float o0 = l > 0.0f ? acc[u][2 * h] / inv : 0.0f;
        const float o1 = l > 0.0f ? acc[u][2 * h + 1] / inv : 0.0f;
        *reinterpret_cast<__nv_bfloat162*>(out_row(r) + col + 2 * q4) =
            __floats2bfloat162_rn(o0, o1);
      }
    }
    return;
  }

  // the split's partial to part[group][split]: acc rows, then m and l
  const int group = (b * Kv + kvh) * gridDim.z + blockIdx.z;
  float* rec = part + ((size_t)group * splits + split) * C::REC;
#pragma unroll
  for (int u = 0; u < C::SLICES; ++u) {
    const int col = 8 * (warp + WARPS * u);
    if (col >= HD) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g4 + 8 * h;
      if (r < nr)
        *reinterpret_cast<float2*>(rec + r * HD + col + 2 * q4) =
            make_float2(acc[u][2 * h], acc[u][2 * h + 1]);
    }
  }
  if (tid < nr) {
    rec[MAX_ROWS * HD + tid] = Mr[tid];
    rec[MAX_ROWS * HD + MAX_ROWS + tid] = Lr[tid];
  }
  __threadfence();
  __syncthreads();
  int* is_last = Qp;                     // the rows' q_pos are read
  if (tid == 0) {
    const int last = atomicAdd(&counters[group], 1) == splits - 1;
    if (last) counters[group] = 0;       // ready for the next launch
    *is_last = last;
  }
  __syncthreads();
  if (!*is_last) return;
  __threadfence();

  // the last block combines the splits in split order, 4 columns a thread
  const float* base = part + (size_t)group * splits * C::REC;
  for (int i = tid; i < nr * HD / 4; i += THREADS) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float M = NEG_INF;
    for (int sp = 0; sp < splits; ++sp)
      M = fmaxf(M, __ldcg(base + (size_t)sp * C::REC + MAX_ROWS * HD + r));
    float L = 0.0f;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const float* rs = base + (size_t)sp * C::REC;
      const float w = expf(__ldcg(rs + MAX_ROWS * HD + r) - M);
      const float4 a = __ldcg(reinterpret_cast<const float4*>(rs + r * HD + c));
      L += __ldcg(rs + MAX_ROWS * HD + MAX_ROWS + r) * w;
      o.x += a.x * w;
      o.y += a.y * w;
      o.z += a.z * w;
      o.w += a.w * w;
    }
    const float inv = fmaxf(L, 1e-20f);
    const bool any = L > 0.0f;
    const uint2 pk = make_uint2(
        pack_bf16(any ? o.x / inv : 0.0f, any ? o.y / inv : 0.0f),
        pack_bf16(any ? o.z / inv : 0.0f, any ? o.w / inv : 0.0f));
    *reinterpret_cast<uint2*>(out_row(r) + c) = pk;
  }
}

template <int HD, int EB>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* q_pos, const void* k_pos, void* out,
           void* part, void* counters, int B, int T, int H, int Kv, int S,
           float scale, int window, int row_blocks, int splits, int tps,
           cudaStream_t stream) {
  const Layout<HD, EB> lay(tps);
  static int allowed[32] = {0};                // bytes set, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32 || lay.total > allowed[dev]) {
    cudaFuncSetAttribute(batch_attention_kernel<HD, EB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         lay.total);
    if (dev < 32) allowed[dev] = lay.total;
  }
  dim3 grid(Kv * splits, B, row_blocks);
  batch_attention_kernel<HD, EB><<<grid, Cfg<HD, EB>::THREADS, lay.total,
                                   stream>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)k, (const uint8_t*)v,
      (const float*)ks, (const float*)vs, (const int*)q_pos,
      (const int*)k_pos, (__nv_bfloat16*)out, (float*)part, (int*)counters,
      T, H, Kv, S, scale, window, splits, tps);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, H, hd) bf16; k/v (B, S, Kv, hd), bf16, or e4m3 with k_scale /
// v_scale (B, S, Kv) f32 (`quantized` 1); q_pos (B, T) i32; k_pos (B, S)
// i32; out (B, T, H, hd) bf16; all contiguous.  hd a multiple of 32, at
// most 256; H a multiple of Kv.  The plan: `row_blocks` blocks of 16 query
// rows, `splits` key splits of `tps` tiles each (split i takes tiles
// [i tps, (i + 1) tps)); with splits > 1, part holds (B Kv row_blocks
// splits) partials of 16 (hd + 2) f32 and counters (B Kv row_blocks) int32,
// zero on entry and left zero.
// Returns cudaGetLastError() after the launch.
extern "C" int batch_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* q_pos, const void* k_pos, void* out,
    void* part, void* counters, int B, int T, int H, int Kv, int S, int hd,
    float scale, int window, int quantized, int row_blocks, int splits,
    int tps, void* stream) {
  if (Kv < 1 || H % Kv || splits < 1 || tps < 1 ||
      row_blocks != ((H / Kv) * T + MAX_ROWS - 1) / MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define BATCH_ATTENTION_HD(D)                                                 \
  case D:                                                                     \
    return quantized                                                          \
               ? launch<D, 1>(q, k, v, k_scale, v_scale, q_pos, k_pos, out,   \
                              part, counters, B, T, H, Kv, S, scale, window,  \
                              row_blocks, splits, tps, st)                    \
               : launch<D, 2>(q, k, v, k_scale, v_scale, q_pos, k_pos, out,   \
                              part, counters, B, T, H, Kv, S, scale, window,  \
                              row_blocks, splits, tps, st);
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
