// Reverse affine time scan for Hopper (sm_90a):
//
//   x_t = b_t + a_t * x_{t+1},  x_T = 0,  t = T-1 .. 0,
//
// over [T, N] float32, N the flattened trailing dims (independent columns).
//
// Replaces two TPU kernels of asyncrl_tpu/ops/pallas_scan.py:
//   linear_scan     <- reverse_linear_scan_pallas     (body _scan_kernel)
//   linear_scan_dma <- reverse_linear_scan_pallas_dma (body _scan_kernel_dma)
//
// Bound on this card: memory. A call reads a and b once and writes x once,
// 12*T*N bytes, and does one fma (2 flops) an element: at T=64, N=8192 it
// moves 6.3 MB (1.9 us at 3.35 TB/s), while the flops take 0.016 us at
// 67 TFLOP/s. The T steps of a column are a chain of dependent fmas, so the
// card runs at its memory rate only if each column's data is in flight well
// ahead of its chain, and if the work around the chain is little: with one
// thread a column, a block has one or two warps an SM partition, and every
// stall of their instruction stream shows. Both designs below put a whole
// T=64 column in flight at once and take 32 columns a block (64 measured
// the same), so N=8192 gives 256 blocks over the 132 SMs. At the port's
// smaller shapes a call is one launch and one round trip.
//
// Rounding: every step is x = __fmaf_rn(a, x, b), one rounding, whatever
// -fmad says. That is the rounding of both JAX kernels on the CPU and of
// JAX's jitted sequential scan (they agree bit for bit). The carry starts
// at a[0] * 0 of its column, as the JAX kernels build their zero from the
// input. Chunking time changes nothing: each step stays one fma in the same
// order. So the two kernels agree bit for bit with each other and with the
// plain version (ops/linear_scan.py).
//
// Both kernels cut time into chunks of rows [c*R, min(c*R + R, T)) and walk
// them from the top, c = C-1 .. 0: only the first chunk walked can be
// partial, and only it runs the guarded walk.
//
// linear_scan: the threads load their own data, one thread a column (the
// counterpart of Pallas feeding _scan_kernel its tiles). A thread loads its
// column's next kRows rows of a and b into registers in one unrolled batch
// of independent 4-byte loads, coalesced across the warp, and issues the
// batch after that one before it runs the kRows fmas of this one: a
// register double buffer (160 registers, no spills), so at T=64 all of a
// column's loads are in flight before its first fma. Ragged N needs
// nothing but the guard of the last block.
//
// linear_scan_dma: the block owns its global -> shared copies, as the JAX
// DMA kernel owns its HBM -> VMEM copies: Hopper bulk asynchronous copies
// that complete on mbarriers. A ring of kStages stages holds kDmaRows-row
// tiles of a and b; each stage has a "full" mbarrier (its copies landed)
// and an "empty" one (its readers are done), each with its own phase bit.
// A producer warp fills stage k % kStages with chunk k as soon as the
// readers of chunk k - kStages have released it, so the copies of the next
// kStages - 1 chunks are in flight while one chunk is walked; at T=64 the
// whole column is in flight at once. The consumer warps walk one thread a
// column: a thread reads its column of the stage into registers, fences and
// releases the stage, then runs the chain of fmas from registers and
// stores x time-major (128 bytes a warp a row). No block-wide barrier after
// the start, and T is not capped.
// How a stage arrives:
// - Every row on the 16-byte grid (N % 4 == 0 and both base pointers
//   aligned: every training path): two 2-D tensor-map copies a stage
//   (cp.async.bulk.tensor.2d), one [kDmaRows, kDmaCols] tile of a and one of
//   b, whose bytes are known in closed form. The host encodes the two maps
//   on every call (cuTensorMapEncodeTiled, a few hundred bytes, no device
//   work).
// - Otherwise (N = 1001, a view that starts off the grid): one 1-D bulk
//   copy (cp.async.bulk) a row segment, lane r of the producer row r of a,
//   lane 16 + r row r of b; the warp sums the lanes' bytes. A bulk copy
//   needs 16-byte aligned addresses and sizes, so a segment that starts
//   `lead` floats past the grid lands at the same offset in its shared row
//   and the copy moves only the floats on whole 16-byte granules; the at
//   most 3 + 3 edge floats of a row are loaded by the threads that own
//   them, before the wait. A chunk starts on a multiple of 4 rows, so row r
//   of every stage has the lead (lead of row 0 + r*N) mod 4, computed once.
//   The copy instruction (UBLKCP in the SASS) takes its operands in uniform
//   registers, so the compiler issues the lanes' copies one lane at a time:
//   a T=64 block's 128 row copies are issued in turn, where the tile path
//   issues 8.
// The results are stored by the threads, not by a bulk store out of shared
// memory: the stores of a warp are already whole 128-byte lines and never
// wait. All shared memory is static and under 48 KB: no launch attribute.

#include <cuda.h>  // CUtensorMap (types only: no driver library is linked)
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// linear_scan
constexpr int kCols = 32;  // threads (columns) a block
constexpr int kRows = 32;  // rows of a register batch

// linear_scan_dma
constexpr int kDmaCols = 32;  // columns a block
constexpr int kDmaRows = 16;  // rows of a stage
constexpr int kStages = 4;
constexpr int kConsumerWarps = kDmaCols / 32;
constexpr int kDmaThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
constexpr int kPitch = kDmaCols + 4;  // shared row in floats: room for a lead of 3
static_assert(kDmaCols % 32 == 0, "consumer warps own 32 columns each");
static_assert(2 * kDmaRows == 32, "one producer lane a row of a or b");

struct __align__(128) DmaSmem {
  float a[kStages][kDmaRows][kPitch];
  float b[kStages][kDmaRows][kPitch];
  uint64_t full[kStages];   // the stage's copies have landed
  uint64_t empty[kStages];  // the stage's readers are done
};
static_assert(sizeof(DmaSmem) <= 48 * 1024, "static shared memory");
static_assert(8 * kDmaRows * kDmaCols < (1 << 20), "a stage's bytes within the tx-count");

// The first `rows` rows of a column of a and b into registers, from pa and
// pb on: 2*rows independent loads, none waited for here.
__device__ __forceinline__ void load_rows(float (&ra)[kRows], float (&rb)[kRows],
                                          const float* pa, const float* pb, int rows, int N) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      ra[r] = __ldg(pa + static_cast<size_t>(r) * N);
      rb[r] = __ldg(pb + static_cast<size_t>(r) * N);
    }
  }
}

// The chain over R rows of a column held in registers, from the top,
// storing each x: `o` points at the column's x in the first of the rows.
// kFull: all R rows, with no guard; otherwise the first `rows`.
template <bool kFull, int R>
__device__ __forceinline__ float walk(const float (&ra)[R], const float (&rb)[R], float x,
                                      float* o, int rows, int N, bool live) {
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    if (kFull || r < rows) {
      x = __fmaf_rn(ra[r], x, rb[r]);
      if (live) o[static_cast<size_t>(r) * N] = x;
    }
  }
  return x;
}

template <int R>
__device__ __forceinline__ float walk_rows(const float (&ra)[R], const float (&rb)[R], float x,
                                           float* o, int rows, int N, bool live) {
  return rows == R ? walk<true>(ra, rb, x, o, rows, N, live)
                   : walk<false>(ra, rb, x, o, rows, N, live);
}

__global__ void __launch_bounds__(kCols)
    linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ out, int T, int N) {
  const int n = blockIdx.x * kCols + threadIdx.x;
  if (n >= N) return;
  const int chunks = (T + kRows - 1) / kRows;
  auto first = [&](int c) { return static_cast<size_t>(c) * kRows * N + n; };
  auto rows = [&](int c) { return min(kRows, T - c * kRows); };
  float x = __fmul_rn(a[n], 0.0f);
  // Two register buffers: chunk c walks from one while chunk c-1 loads
  // into the other.
  float a0[kRows], b0[kRows], a1[kRows], b1[kRows];
  int c = chunks - 1;
  load_rows(a0, b0, a + first(c), b + first(c), rows(c), N);
  for (;; c -= 2) {
    if (c >= 1) load_rows(a1, b1, a + first(c - 1), b + first(c - 1), kRows, N);
    x = walk_rows(a0, b0, x, out + first(c), rows(c), N, true);
    if (c == 0) break;
    if (c >= 2) load_rows(a0, b0, a + first(c - 2), b + first(c - 2), kRows, N);
    x = walk<true>(a1, b1, x, out + first(c - 1), kRows, N, true);
    if (c == 1) break;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive, and add `bytes` to the bytes the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` contiguous bytes, global -> shared.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The [kDmaRows, kDmaCols] box of `map` at (row, col), global -> shared,
// rows kDmaCols floats apart; what lies past T or N reads as 0.
__device__ __forceinline__ void tile_copy(float* dst, const CUtensorMap* map, int row, int col,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// Of a row segment of `width` floats that starts `lead` floats past the
// 16-byte grid, floats [j0, j1) lie on whole 16-byte granules.
struct Span {
  int j0, j1;
};

__device__ __forceinline__ Span aligned_span(int lead, int width) {
  const int j0 = min((4 - lead) & 3, width);
  return {j0, j0 + ((width - j0) & ~3)};
}

// kTiles: every row is on the 16-byte grid (N % 4 == 0, both base pointers
// aligned), and a stage arrives as two tensor-map tiles, rows kDmaCols floats
// apart. Otherwise a stage arrives row by row, kPitch floats apart.
template <bool kTiles>
__global__ void __launch_bounds__(kDmaThreads)
    linear_scan_dma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           float* __restrict__ out, int T, int N,
                           const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b) {
  __shared__ DmaSmem sm;
  const int c0 = blockIdx.x * kDmaCols;
  const int width = min(kDmaCols, N - c0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = (T + kDmaRows - 1) / kDmaRows;
  // Floats past the 16-byte grid of row 0's segment. Row t adds t*N, and a
  // chunk starts on a multiple of 4 rows, so row r of every stage has the
  // same lead: (lead + r*N) mod 4.
  const int lead_a = static_cast<int>((reinterpret_cast<uintptr_t>(a + c0) >> 2) & 3);
  const int lead_b = static_cast<int>((reinterpret_cast<uintptr_t>(b + c0) >> 2) & 3);
  const int step = N & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // Producer: chunk k (the k-th walked) into stage k % kStages, once the
    // readers of chunk k - kStages are done with it. Per row, lane r < 16
    // copies row r of a, lane 16 + r row r of b.
    const int r = lane % kDmaRows;
    const bool of_b = lane >= kDmaRows;
    const int lead = ((of_b ? lead_b : lead_a) + r * step) & 3;
    const Span sp = aligned_span(lead, width);
    const float* src = (of_b ? b : a) + c0 + sp.j0;
    for (int k = 0; k < chunks; ++k) {
      const int s = k % kStages;
      const int lo = (chunks - 1 - k) * kDmaRows;
      const int rows = min(kDmaRows, T - lo);
      if (k >= kStages) mbar_wait(&sm.empty[s], (k / kStages - 1) & 1);
      if (kTiles) {
        // A tile's bytes count in full, the zeros past T and N included.
        if (lane == 0) {
          mbar_expect_tx(&sm.full[s], 8u * kDmaRows * kDmaCols);
          tile_copy(&sm.a[s][0][0], &map_a, lo, c0, &sm.full[s]);
          tile_copy(&sm.b[s][0][0], &map_b, lo, c0, &sm.full[s]);
        }
        continue;
      }
      const uint32_t mine = r < rows ? 4u * static_cast<uint32_t>(sp.j1 - sp.j0) : 0u;
      const uint32_t bytes = __reduce_add_sync(0xffffffffu, mine);
      if (lane == 0) mbar_expect_tx(&sm.full[s], bytes);
      __syncwarp();
      if (mine) {
        float* dst = (of_b ? sm.b[s][r] : sm.a[s][r]) + lead + sp.j0;
        bulk_copy(dst, src + static_cast<size_t>(lo + r) * N, mine, &sm.full[s]);
      }
    }
    return;
  }

  // Consumers: thread j walks column c0 + j.
  const int j = threadIdx.x;
  const bool live = j < width;
  // Row path: each stage row's lead (2 bits a row) and whether float j of
  // the row lies off the copied span, so that this thread loads it itself.
  uint32_t leads_a = 0, leads_b = 0, edge_a = 0, edge_b = 0;
  if (!kTiles) {
#pragma unroll
    for (int r = 0; r < kDmaRows; ++r) {
      const int la = (lead_a + r * step) & 3, lb = (lead_b + r * step) & 3;
      const Span sa = aligned_span(la, width), sb = aligned_span(lb, width);
      leads_a |= static_cast<uint32_t>(la) << (2 * r);
      leads_b |= static_cast<uint32_t>(lb) << (2 * r);
      if (live && (j < sa.j0 || j >= sa.j1)) edge_a |= 1u << r;
      if (live && (j < sb.j0 || j >= sb.j1)) edge_b |= 1u << r;
    }
  }
  float x = live ? __fmul_rn(a[c0 + j], 0.0f) : 0.0f;
  for (int k = 0; k < chunks; ++k) {
    const int s = k % kStages;
    const int lo = (chunks - 1 - k) * kDmaRows;
    const int rows = min(kDmaRows, T - lo);
    const size_t g = static_cast<size_t>(lo) * N + c0 + j;
    float ra[kDmaRows], rb[kDmaRows];
    if (!kTiles && (edge_a | edge_b)) {
#pragma unroll
      for (int r = 0; r < kDmaRows; ++r) {
        if (r < rows && (edge_a >> r & 1u)) ra[r] = a[g + static_cast<size_t>(r) * N];
        if (r < rows && (edge_b >> r & 1u)) rb[r] = b[g + static_cast<size_t>(r) * N];
      }
    }
    mbar_wait(&sm.full[s], (k / kStages) & 1);
    const float* ta = &sm.a[s][0][j];
    const float* tb = &sm.b[s][0][j];
#pragma unroll
    for (int r = 0; r < kDmaRows; ++r) {
      if (kTiles) {
        ra[r] = ta[r * kDmaCols];
        rb[r] = tb[r * kDmaCols];
      } else {
        if (!(edge_a >> r & 1u)) ra[r] = ta[r * kPitch + (leads_a >> (2 * r) & 3u)];
        if (!(edge_b >> r & 1u)) rb[r] = tb[r * kPitch + (leads_b >> (2 * r) & 3u)];
      }
    }
    // The stage's reads are done: order them before the bulk copies that
    // refill it, then release it to the producer.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
    x = walk_rows(ra, rb, x, out + g, rows, N, live);
  }
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int linear_scan_launch(const float* a, const float* b, float* out, int T,
                                  int N, void* stream) {
  const int blocks = (N + kCols - 1) / kCols;
  linear_scan_kernel<<<blocks, kCols, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out,
                                                                              T, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linear_scan_dma_launch(const float* a, const float* b, float* out,
                                      int T, int N, void* stream) {
  const int blocks = (N + kDmaCols - 1) / kDmaCols;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[2] = {};
  const bool tiles = N % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (!tiles) {
    linear_scan_dma_kernel<false><<<blocks, kDmaThreads, 0, st>>>(a, b, out, T, N, maps[0],
                                                                  maps[1]);
    return static_cast<int>(cudaGetLastError());
  }
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), 12000, cudaEnableDefault,
        &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess) return static_cast<int>(cudaErrorSymbolNotFound);
  }
  // [T, N] row-major: dim 0 the N columns, dim 1 the T rows, N*4 bytes apart.
  const float* base[2] = {a, b};
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(T)};
    const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(N) * sizeof(float)};
    const cuuint32_t box[2] = {kDmaCols, kDmaRows};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                              const_cast<float*>(base[i]), dims, row_bytes, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  linear_scan_dma_kernel<true><<<blocks, kDmaThreads, 0, st>>>(a, b, out, T, N, maps[0],
                                                               maps[1]);
  return static_cast<int>(cudaGetLastError());
}
