// Hopper (sm_90a) machinery for the fp8 GEMM kernels (fp8_gemm.cu,
// fp8_grouped_gemm.cu): the bit-exact e4m3 activation cast, TMA tensor maps,
// mbarrier producer/consumer rings, warpgroup MMAs (wgmma), and the f16
// operands made of e4m3 values that the kernels' main loops run on (the
// f32 sums the Pallas kernels define; see "16-bit operands" below).
//
// Operand layout.  Tiles are read K-major from shared memory.  A tile is R
// rows of 128 bytes of K (128 e4m3 values, or 64 f16), loaded by one TMA
// copy with the 128-byte swizzle: row r at byte r * 128, its 16-byte granule
// g stored at granule g ^ (r % 8).  The tile's base is 1024-byte aligned, so
// the wgmma descriptor of the swizzled layout (stride 1024 bytes between
// groups of 8 rows) addresses it directly, and the k-th 32-byte slice of
// the row is the same descriptor with its start address advanced by 32 k
// bytes.
//
// Tensor maps are built on the host with cuTensorMapEncodeTiled, reached
// through the runtime's driver entry point (no -lcuda), and passed to the
// kernels as __grid_constant__ parameters.  A box that runs past the tensor
// is filled with zeros, which is how the ragged edges of M, N and K are
// handled: a zero row or k column adds nothing to the product.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int CHUNK = 128;   // bytes of K a tile row holds: one swizzle row
constexpr float FP8_MAX = 448.0f;

// ---------------------------------------------------------------------------
// Device: dynamic e4m3 quantization, bit-identical to
// repro.core.quant.cast_to_fp8: a true IEEE division (never a reciprocal
// multiply), the clip, then the saturating round-to-nearest conversion
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t quant_e4m3(float x, float s) {
  float y = __fdiv_rn(x, s);
  y = fminf(fmaxf(y, -FP8_MAX), FP8_MAX);
  return (uint32_t)__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
}

// max(a, |v|) over the 8 bf16 of a 16-byte load
__device__ __forceinline__ float amax8(const uint4 v, float a) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    a = fmaxf(a, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return a;
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A map over e4m3 bytes viewed as (batch, rows, K), K innermost: row stride
// `ld` bytes, batch stride `lb` bytes (both multiples of 16), boxes of one
// 128-byte chunk x `box_rows` rows x 1, 128-byte swizzle, zeros outside.
// Returns 0, or minus the CUresult of a refused encoding (-999 when the
// driver has no cuTensorMapEncodeTiled).
inline int make_k_major_map(CUtensorMap* map, const void* base, uint64_t K,
                            uint64_t rows, uint64_t batch, uint64_t ld,
                            uint64_t lb, uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -999;
  const cuuint64_t dims[3] = {K, rows, batch};
  const cuuint64_t strides[2] = {ld, lb};
  const cuuint32_t box[3] = {(cuuint32_t)CHUNK, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// A map over f16 viewed as (batch, rows, K), K innermost: row stride `ld`
// bytes, batch stride `lb` bytes (multiples of 16), boxes of 64 values (one
// 128-byte swizzle row) x `box_rows` rows x 1, 128-byte swizzle, zeros
// outside.  Returns as make_k_major_map.
inline int make_f16_k_major_map(CUtensorMap* map, const void* base,
                                uint64_t K, uint64_t rows, uint64_t batch,
                                uint64_t ld, uint64_t lb, uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -999;
  const cuuint64_t dims[3] = {K, rows, batch};
  const cuuint64_t strides[2] = {ld, lb};
  const cuuint32_t box[3] = {(cuuint32_t)(CHUNK / 2), box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// A map over f32 viewed as (batch, rows, cols), cols innermost: row stride
// `ld` bytes, batch stride `lb` bytes (multiples of 16), boxes of
// `box_cols` x 1 x 1, no swizzle, zeros outside.  Returns as
// make_k_major_map.
inline int make_f32_row_map(CUtensorMap* map, const void* base, uint64_t cols,
                            uint64_t rows, uint64_t batch, uint64_t ld,
                            uint64_t lb, uint32_t box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -999;
  const cuuint64_t dims[3] = {cols, rows, batch};
  const cuuint64_t strides[2] = {ld, lb};
  const cuuint32_t box[3] = {box_cols, 1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// ---------------------------------------------------------------------------
// Device: shared-memory addresses, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return (uint8_t*)(((uintptr_t)p + 1023) & ~(uintptr_t)1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::
          "r"(smem_u32(bar))
      : "memory");
}

// waits until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// fetches a tensor map into the cache ahead of its first copy
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)map) : "memory");
}

// TMA: the box at (k, row, batch) of `map` into shared memory at `dst`; its
// bytes count as transactions on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(k), "r"(row), "r"(batch)
      : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// descriptor of a K-major tile with the 128-byte swizzle at `tile` (1024-byte
// aligned): start address >> 4, stride 1024 bytes between 8-row groups,
// layout type 1 (128-byte swizzle); the leading offset is unused here
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the descriptor of the k-th 32-byte slice of a 128-byte tile row
__device__ __forceinline__ uint64_t desc_k(uint64_t desc, int k) {
  return desc + (uint64_t)(2 * k);   // 32 bytes, in 16-byte units
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// register budget of the calling warpgroup (all its warps execute it): a
// producer gives registers back, the consumers take them
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// keeps the compiler from moving reads or writes of the accumulator
// registers across the asynchronous MMAs
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout (m64nNk16, f32): thread t of the warpgroup holds, for
// each 8-column group j < N / 8, d[4j + 2h + c] = D[row, col] with
//   row = 16 (t / 32) + (t % 32) / 4 + 8 h,  col = 8 j + 2 (t % 4) + c.

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// Device: 16-bit operands made of e4m3 values (f32 sums of exact products)
// ---------------------------------------------------------------------------
//
// fp8 wgmma keeps fewer bits than f32 in its sums (about 14; DeepSeek-V3
// technical report, section 3.3.2), so the GEMMs feed wgmma f16 operands
// instead: every e4m3 value, subnormals included, is an f16 normal or zero,
// so the conversion is exact; the product of two such values has at most 8
// significant bits, so it is exact in f32; and f16 wgmma accumulates in f32.
// The weight's bytes from HBM stay e4m3: its tile lands in shared memory as
// e4m3 and each thread converts its A fragment in registers.  The
// activations, re-read from L2 by every block of their rows, are written
// once as f16 by the quantization passes: the B operand, which TMA copies
// to shared memory as it is.
//
// The k order inside a 128-deep chunk.  Thread t of a warpgroup (warp w,
// lane 4 r + q) loads rows R and R + 8 (R = 16 w + r of the warpgroup's 64)
// of a 128-byte swizzled e4m3 tile with two 16-byte loads a row, granules
// 2q and 2q + 1 (bytes 32q .. 32q + 31), and its word s (bytes 32q + 4s ..
// 32q + 4s + 3) feeds the chunk's k16 step s:
//   a[4s]     = row R,     fragment k 2q, 2q + 1     <- bytes 32q + 4s + 0, 1
//   a[4s + 2] = row R,     fragment k 2q + 8, 2q + 9 <- bytes 32q + 4s + 2, 3
//   a[4s + 1], a[4s + 3]: the same of row R + 8
// (the f16 A fragment of wgmma m64nNk16).  So the chunk's position
// L = 16 s + j stands for its physical k
//   phys(L) = 32 ((j % 8) / 2) + 4 s + 2 (j / 8) + j % 2,
// and the B operand, f16 in shared memory, must hold physical k phys(L) at
// position L: the quantization passes write the activations so, an 8-value
// vector v of the chunk (physical k 8v .. 8v + 7) as four f16 pairs at
//   L = 32 (v % 4) + 2 (v / 4) + 8 i,  i = 0 .. 3      (perm_pair below)
// A sum is a sum in any order of its terms, so the product is unchanged.

// two e4m3 bytes (the low 16 bits) -> two f16 (low value in the low half)
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(two & 0xFFFFu), __NV_E4M3);
  return (uint32_t)h.x | ((uint32_t)h.y << 16);
}

// 8 bf16 of a 16-byte load cast to e4m3 with scale s (quant_e4m3), as four
// f16 pairs: elements (0, 1), (2, 3), (4, 5), (6, 7)
__device__ __forceinline__ uint4 quant8_f16(const uint4 v, float s) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[i] = e4m3x2_to_f16x2(quant_e4m3(f.x, s) | (quant_e4m3(f.y, s) << 8));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the f16-pair index (32-bit word) within a 128-deep chunk of pair i of the
// chunk's 8-value vector v (the k order above)
__device__ __forceinline__ int perm_pair(int v, int i) {
  return 16 * (v % 4) + v / 4 + 4 * i;
}

// the four pairs of `q` (vector c of a row: chunk c / 16, vector c % 16) into
// the row's f16 copy `row` (32-bit words) in the chunk's k order
__device__ __forceinline__ void store_perm8(uint32_t* __restrict__ row, int c,
                                            const uint4 q) {
  uint32_t* dst = row + (c / 16) * (CHUNK / 2);
  const int v = c % 16;
  dst[perm_pair(v, 0)] = q.x;
  dst[perm_pair(v, 1)] = q.y;
  dst[perm_pair(v, 2)] = q.z;
  dst[perm_pair(v, 3)] = q.w;
}

// rows `row` and row + 8 of a 128-byte swizzled e4m3 tile (row % 8 as the
// swizzle phase, the tile 1024-byte aligned) as the f16 A fragments of the
// chunk's eight k16 steps: a[4s .. 4s + 3] for step s
__device__ __forceinline__ void load_a_chunk(const uint8_t* tile, int row,
                                             int q, uint32_t (&a)[32]) {
  const int ph = row % 8;
  const uint8_t* lo = tile + row * CHUNK;
  const uint8_t* hi = lo + 8 * CHUNK;
  uint4 g[4];
  g[0] = *reinterpret_cast<const uint4*>(lo + (((2 * q) ^ ph) << 4));
  g[1] = *reinterpret_cast<const uint4*>(lo + (((2 * q + 1) ^ ph) << 4));
  g[2] = *reinterpret_cast<const uint4*>(hi + (((2 * q) ^ ph) << 4));
  g[3] = *reinterpret_cast<const uint4*>(hi + (((2 * q + 1) ^ ph) << 4));
  const uint32_t wl[8] = {g[0].x, g[0].y, g[0].z, g[0].w,
                          g[1].x, g[1].y, g[1].z, g[1].w};
  const uint32_t wh[8] = {g[2].x, g[2].y, g[2].z, g[2].w,
                          g[3].x, g[3].y, g[3].z, g[3].w};
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    a[4 * s] = e4m3x2_to_f16x2(wl[s]);
    a[4 * s + 1] = e4m3x2_to_f16x2(wh[s]);
    a[4 * s + 2] = e4m3x2_to_f16x2(wl[s] >> 16);
    a[4 * s + 3] = e4m3x2_to_f16x2(wh[s] >> 16);
  }
}

// the descriptor of k16 step s (0 .. 7) of an f16 B tile of `rows` rows x
// 128 k, stored as two 64-deep halves (one TMA box each) of rows x 128 bytes
__device__ __forceinline__ uint64_t desc_f16_step(const uint8_t* tile,
                                                  int rows, int s) {
  return desc_k(desc_sw128(tile + (s / 4) * rows * CHUNK), s % 4);
}

// D (64 x 8, f32, 4 registers a thread) = A . B^T (+ D when scale_d),
// A (64 x 16) f16 from registers (the fragment above), B (8 x 16) f16
// K-major in shared memory
__device__ __forceinline__ void wgmma_f16_m64n8k16(float (&d)[4],
                                                const uint32_t* a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// D (64 x 16, f32, 8 registers a thread) = A . B^T (+ D when scale_d),
// A (64 x 16) f16 from registers (the fragment above), B (16 x 16) f16
// K-major in shared memory
__device__ __forceinline__ void wgmma_f16_m64n16k16(float (&d)[8],
                                                const uint32_t* a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// D (64 x 32, f32, 16 registers a thread) = A . B^T (+ D when scale_d),
// A (64 x 16) f16 from registers (the fragment above), B (32 x 16) f16
// K-major in shared memory
__device__ __forceinline__ void wgmma_f16_m64n32k16(float (&d)[16],
                                                const uint32_t* a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// D (64 x 128, f32, 64 registers a thread) = A . B^T (+ D when scale_d),
// A (64 x 16) f16 from registers (the fragment above), B (128 x 16) f16
// K-major in shared memory
__device__ __forceinline__ void wgmma_f16_m64n128k16(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

}  // namespace sm90
