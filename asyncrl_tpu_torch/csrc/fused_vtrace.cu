// Fused V-trace tail for Hopper (sm_90a).
//
// Replaces the TPU kernel asyncrl_tpu/ops/pallas_scan.py::fused_vtrace_pallas
// (body _fused_vtrace_kernel). Given the pre-clipped importance weights it
// computes, walking time backwards with the boundary V_T = vs_T = bootstrap
// and x_T = 0:
//
//   delta_t = crho_t * ((r_t + d_t * V_{t+1}) - V_t)
//   x_t     = delta_t + a_t * x_{t+1}          (a_t = d_t * min(c_bar, rho_t))
//   vs_t    = x_t + V_t
//   pg_t    = crho_t * ((r_t + d_t * vs_{t+1}) - V_t)
//
// and writes vs, vs - V (= x) and pg.
//
// Rounding: the JAX kernel's. The recurrence is one rounded fused
// multiply-add (XLA contracts it on the CPU), while the TD and pg products
// are rounded on their own (mul_no_fma fences them there); x starts as
// boot * 0. The intrinsics below pin both choices, whatever -fmad says, and
// every value is computed by the same operations in the same order as in the
// plain version (ops/fused_vtrace.py), so the two agree bit for bit.
//
// Bound on this card: memory. Each call reads 5*T*B + B floats and writes
// 3*T*B, about 11 flops an element: at T=64, B=8192 it moves 16.8 MB (5.0 us
// at 3.35 TB/s); at T=32, B=1024 1.05 MB (0.3 us), where a launch and one
// round trip to device memory are the floor.
//
// Design. Only x_t = delta_t + a_t * x_{t+1} is serial; delta, vs and pg are
// elementwise around it. A block of 256 threads owns a tile of 32 columns
// (128-byte rows) and walks time backwards in chunks of up to 32 rows:
//
// - Staging: each chunk's five input tiles are copied global -> shared with
//   cp.async, all of them in flight before one wait: 16-byte copies where
//   the row stride B*4 and the inputs are on the 16-byte grid, 4-byte copies
//   otherwise (B = 1001 has rows off that grid). So the walk waits on device
//   memory once per chunk, not once per time step.
// - Double buffering: chunk k+1's copies are in flight while chunk k is
//   worked, and chunk k+2's are issued as soon as chunk k's tiles are free.
//   T is not capped.
// - Per chunk, three phases: every thread computes delta of its rows from
//   shared memory (warp w takes rows w, w+8, ...: one 128-byte row a warp);
//   then warp 0 walks the recurrence, one thread per column, reading its
//   column into registers first so the chain is fmas only; then every
//   thread computes vs, vs - V and pg (vs_{t+1} is x_{t+1} + V_{t+1}, the
//   same rounded sum) and stores them time-major, 128 bytes a warp. The
//   carries across chunks (x in warp 0's registers, V_{t+1} and vs_{t+1} in
//   shared memory) take the place of the TPU grid's carried VMEM scratch.
// - Grid: ceil(B / 32) blocks: 256 at B = 8192, which covers the 132 SMs.
//   At B <= 1024 the card cannot be filled; there a call is one launch and
//   one round trip per chunk.
//
// cp.async and not TMA: a TMA tile load needs a tensor map for each of the
// five inputs, encoded on the host every call (cuTensorMapEncodeTiled), and
// at these tile sizes (4 KB an input) cp.async gets every copy of a chunk
// in flight as well, and also takes rows off the 16-byte grid.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 32;  // columns of a block: one warp's width
constexpr int kRows = 32;  // time steps of a chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kInputs = 5;  // crho, coeff, rew, disc, val
constexpr int kCrho = 0, kCoeff = 1, kRew = 2, kDisc = 3, kVal = 4;
constexpr int kTile = kRows * kCols;

struct Inputs {
  const float* p[kInputs];
};

struct __align__(16) Smem {
  float in[2][kInputs][kTile];  // the input tiles of two chunks
  float x[kTile];               // delta, then x, of the chunk being worked
  float v_next[kCols];          // V_{t+1} and vs_{t+1} below the chunk's last row
  float vs_next[kCols];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Every copy group but the newest one has landed (this thread's copies).
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Rows [lo, lo + rows) of the block's `width` columns from c0, of every
// input, into tiles[input][row * kCols + column].
__device__ __forceinline__ void issue_chunk(float (*tiles)[kTile], const Inputs& in, int lo,
                                            int rows, int c0, int width, int B, bool vec) {
  if (vec) {
    for (int s = threadIdx.x; s < rows * (kCols / 4); s += kThreads) {
      const int r = s / (kCols / 4);
      const int j = 4 * (s % (kCols / 4));
      if (j >= width) continue;
      const size_t g = static_cast<size_t>(lo + r) * B + c0 + j;
#pragma unroll
      for (int k = 0; k < kInputs; ++k) cp_async16(tiles[k] + r * kCols + j, in.p[k] + g);
    }
  } else {
    for (int s = threadIdx.x; s < rows * kCols; s += kThreads) {
      const int r = s / kCols;
      const int j = s % kCols;
      if (j >= width) continue;
      const size_t g = static_cast<size_t>(lo + r) * B + c0 + j;
#pragma unroll
      for (int k = 0; k < kInputs; ++k) cp_async4(tiles[k] + r * kCols + j, in.p[k] + g);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_vtrace_kernel(Inputs in, const float* __restrict__ boot, float* __restrict__ vs,
                        float* __restrict__ adv, float* __restrict__ pg, int T, int B,
                        bool vec) {
  __shared__ Smem sm;
  const int c0 = blockIdx.x * kCols;
  const int width = min(kCols, B - c0);
  const int j = threadIdx.x % kCols;  // the thread's column
  const int w = threadIdx.x / kCols;  // its warp: rows w, w + kWarps, ...
  const bool live = j < width;
  const int chunks = (T + kRows - 1) / kRows;

  // Chunk k holds rows [lo, hi), hi = T - k*kRows: the walk's k-th.
  auto bounds = [T](int k, int& lo, int& rows) {
    const int hi = T - k * kRows;
    lo = max(hi - kRows, 0);
    rows = hi - lo;
  };

  float x = 0.0f;  // warp 0: the recurrence's carry of column j
  if (w == 0) {
    const float b = live ? boot[c0 + j] : 0.0f;
    sm.v_next[j] = b;
    sm.vs_next[j] = b;
    x = __fmul_rn(b, 0.0f);  // the JAX kernel seeds x with boot * 0
  }
  for (int k = 0; k < 2; ++k) {
    int lo, rows;
    bounds(k, lo, rows);
    if (k < chunks) issue_chunk(sm.in[k], in, lo, rows, c0, width, B, vec);
    cp_async_commit();
  }

  for (int k = 0; k < chunks; ++k) {
    int lo, rows;
    bounds(k, lo, rows);
    const float(*t)[kTile] = sm.in[k & 1];
    cp_async_wait_all_but_newest();
    __syncthreads();

    // delta_t, every thread.
    for (int r = w; r < rows; r += kWarps) {
      const int e = r * kCols + j;
      const float v_next = r + 1 < rows ? t[kVal][e + kCols] : sm.v_next[j];
      sm.x[e] = __fmul_rn(t[kCrho][e],
                          __fsub_rn(__fadd_rn(t[kRew][e], __fmul_rn(t[kDisc][e], v_next)),
                                    t[kVal][e]));
    }
    __syncthreads();

    // x_t = delta_t + a_t * x_{t+1}, one thread a column.
    if (w == 0) {
      float a[kRows], delta[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          a[r] = t[kCoeff][r * kCols + j];
          delta[r] = sm.x[r * kCols + j];
        }
      }
#pragma unroll
      for (int r = kRows - 1; r >= 0; --r) {
        if (r < rows) {
          x = __fmaf_rn(a[r], x, delta[r]);
          sm.x[r * kCols + j] = x;
        }
      }
    }
    __syncthreads();

    // vs_t, x_t and pg_t, every thread; the carries of row 0 stay in
    // registers until the tiles are free.
    float carry_v = 0.0f, carry_vs = 0.0f;
    for (int r = w; r < rows; r += kWarps) {
      const int e = r * kCols + j;
      const float xv = sm.x[e];
      const float v = t[kVal][e];
      const float s = __fadd_rn(xv, v);
      const float vs_next =
          r + 1 < rows ? __fadd_rn(sm.x[e + kCols], t[kVal][e + kCols]) : sm.vs_next[j];
      const float p = __fmul_rn(
          t[kCrho][e], __fsub_rn(__fadd_rn(t[kRew][e], __fmul_rn(t[kDisc][e], vs_next)), v));
      if (live) {
        const size_t g = static_cast<size_t>(lo + r) * B + c0 + j;
        adv[g] = xv;
        vs[g] = s;
        pg[g] = p;
      }
      if (r == 0) {
        carry_v = v;
        carry_vs = s;
      }
    }
    __syncthreads();

    // Row 0 (warp 0's) carries V and vs into the next chunk; this chunk's
    // tiles take chunk k+2's copies.
    if (w == 0) {
      sm.v_next[j] = carry_v;
      sm.vs_next[j] = carry_vs;
    }
    if (k + 2 < chunks) {
      int lo2, rows2;
      bounds(k + 2, lo2, rows2);
      issue_chunk(sm.in[k & 1], in, lo2, rows2, c0, width, B, vec);
    }
    cp_async_commit();
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_vtrace_launch(const float* crho, const float* coeff,
                                   const float* rew, const float* disc,
                                   const float* val, const float* boot,
                                   float* vs, float* adv, float* pg, int T,
                                   int B, void* stream) {
  const Inputs in = {{crho, coeff, rew, disc, val}};
  bool vec = B % 4 == 0;
  for (const float* p : in.p) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int blocks = (B + kCols - 1) / kCols;
  fused_vtrace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, boot, vs, adv, pg, T, B, vec);
  return static_cast<int>(cudaGetLastError());
}
