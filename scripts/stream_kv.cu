// Streaming rate of a decode attention's K/V read on the card, apart from
// any attention arithmetic: blocks of 256 or more threads read the K and V
// rows of one KV head over a range of keys of a (B, S, Kv, 256-byte) cache,
// as kernel batch_attention's blocks do, four ways.  Built and run by
// scripts/stream_kv.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one row by the TMA unit, completing on `bar`
__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         uint32_t n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(n), "r"(smem_u32(bar))
      : "memory");
}

constexpr int RB = 256;    // bytes of a key's row of one head (bf16, hd 128)
constexpr int TILE = 128;  // keys a tile; 2 stages

struct Range {
  int kvh, b, s0, n_tiles;
  __device__ Range(int S, int splits) {
    kvh = blockIdx.x / splits;
    b = blockIdx.y;
    const int per = (S + splits - 1) / splits, sp = blockIdx.x % splits;
    s0 = sp * per;
    n_tiles = (min(S, s0 + per) - s0 + TILE - 1) / TILE;
  }
  __device__ size_t row(int S, int Kv, int t, int j) const {
    const int s = min(s0 + t * TILE + j, S - 1);
    return (((size_t)b * S + s) * Kv + kvh) * RB;
  }
};

// 16-byte cp.async into a 2-stage ring; rows PAD bytes apart beyond RB
template <int PAD>
__global__ void by_cp_async(const uint8_t* k, const uint8_t* v, int S,
                            int Kv, int splits, int* sink) {
  extern __shared__ __align__(16) uint8_t sm[];
  constexpr int RS = RB + PAD, STAGE = 2 * TILE * RS;
  const Range r(S, splits);
  auto issue = [&](int t) {
    if (t < r.n_tiles) {
      uint8_t* st = sm + (t % 2) * STAGE;
      for (int i = threadIdx.x; i < TILE * RB / 16; i += blockDim.x) {
        const int j = i / (RB / 16), c = (i % (RB / 16)) * 16;
        const size_t off = r.row(S, Kv, t, j) + c;
        cp_async16(st + j * RS + c, k + off);
        cp_async16(st + TILE * RS + j * RS + c, v + off);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  int acc = 0;
  issue(0);
  for (int t = 0; t < r.n_tiles; ++t) {
    issue(t + 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    acc ^= *reinterpret_cast<int*>(sm + (t % 2) * STAGE + 4 * threadIdx.x);
    __syncthreads();
  }
  if (acc == 0x5a5a5a5a) sink[0] = acc;
}

// one TMA bulk copy a row into a 2-stage ring, an mbarrier a stage
__global__ void by_bulk(const uint8_t* k, const uint8_t* v, int S, int Kv,
                        int splits, int* sink) {
  extern __shared__ __align__(128) uint8_t sm[];
  __shared__ __align__(8) uint64_t bar[2];
  constexpr int STAGE = 2 * TILE * RB;
  const Range r(S, splits);
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t) {
    if (t < r.n_tiles && threadIdx.x < 32) {
      uint8_t* st = sm + (t % 2) * STAGE;
      if (threadIdx.x == 0) mbar_expect_tx(&bar[t % 2], STAGE);
      __syncwarp();
      for (int j = threadIdx.x; j < TILE; j += 32) {
        const size_t off = r.row(S, Kv, t, j);
        bulk_row(st + j * RB, k + off, RB, &bar[t % 2]);
        bulk_row(st + TILE * RB + j * RB, v + off, RB, &bar[t % 2]);
      }
    }
  };
  int acc = 0;
  issue(0);
  for (int t = 0; t < r.n_tiles; ++t) {
    issue(t + 1);
    mbar_wait(&bar[t % 2], (t / 2) & 1);
    acc ^= *reinterpret_cast<int*>(sm + (t % 2) * STAGE + 4 * threadIdx.x);
    __syncthreads();
  }
  if (acc == 0x5a5a5a5a) sink[0] = acc;
}

// plain 16-byte loads into registers
__global__ void by_loads(const uint8_t* k, const uint8_t* v, int S, int Kv,
                         int splits, int* sink) {
  const Range r(S, splits);
  uint32_t acc = 0;
  const int n = r.n_tiles * TILE * (RB / 16);
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = i / (RB / 16), c = (i % (RB / 16)) * 16;
    const size_t off = r.row(S, Kv, j / TILE, j % TILE) + c;
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(k + off));
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(v + off));
    acc ^= a.x ^ w.x;
  }
  if (acc == 0x5a5a5a5a) sink[0] = (int)acc;
}

template <class F>
int launch(F f, int smem, dim3 grid, int threads, const void* k,
           const void* v, int S, int Kv, int splits, void* sink,
           cudaStream_t st) {
  if (smem) cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
  f<<<grid, threads, smem, st>>>((const uint8_t*)k, (const uint8_t*)v, S, Kv,
                                 splits, (int*)sink);
  return (int)cudaGetLastError();
}

}  // namespace

// way 0: cp.async, unpadded rows; 1: cp.async, rows padded by 16 bytes;
// 2: TMA bulk copies; 3: plain loads.  k/v (B, S, Kv, 256 bytes); grid
// (Kv * splits, B).  Returns cudaGetLastError() after the launch.
extern "C" int stream_kv(int way, const void* k, const void* v, int B, int S,
                         int Kv, int splits, int threads, void* sink,
                         void* stream) {
  const dim3 grid(Kv * splits, B);
  cudaStream_t st = (cudaStream_t)stream;
  switch (way) {
    case 0:
      return launch(by_cp_async<0>, 2 * 2 * TILE * RB, grid, threads, k, v, S,
                    Kv, splits, sink, st);
    case 1:
      return launch(by_cp_async<16>, 2 * 2 * TILE * (RB + 16), grid, threads,
                    k, v, S, Kv, splits, sink, st);
    case 2:
      return launch(by_bulk, 2 * 2 * TILE * RB, grid, threads, k, v, S, Kv,
                    splits, sink, st);
    case 3:
      return launch(by_loads, 0, grid, threads, k, v, S, Kv, splits, sink, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
