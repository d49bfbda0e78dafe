// The bidirectional ring all-reduce of ranks that share one card, as one
// pass in the ring's fold order, for Hopper (sm_90a).
//
// Replaces the TPU kernel asyncrl_tpu/ops/ring_reduce.py::ring_all_reduce_pallas
// (body _ring_kernel), which sends chunks between chips by remote copies into
// VMEM landing slots. Here every rank's payload is a row of one tensor,
// x[n ranks][stride] f32 (D floats used), and the result is written once,
// out[D]: what every rank ends the ring with.
//
// What the ring computes. The payload is cut as the JAX module cuts it
// (_to_chunks): flat index i lies in direction dir = i / (n*chunk) and in
// chunk c = (i / chunk) % n, chunk = S*128 with S a multiple of 8, so a chunk
// is a multiple of 1024 floats. The lax twin's schedule (_ring_passes_lax:
// reduce-scatter step s sends chunk idx - sign*s and folds the chunk
// idx - sign*(s+1) as local + incoming, sign +1 for direction 0 and -1 for
// direction 1) starts chunk c on rank c and folds it in on ranks c+sign,
// c+2*sign, ...; the all-gather only copies. So every rank ends with
//
//   acc = x[c][i];  for k = 1 .. n-1:  acc = x[(c + k*sign) mod n][i] + acc
//
// one rounded f32 add each (__fadd_rn, whatever -fmad says). This kernel
// computes exactly that, so it equals the plain version (ops/ring_reduce.py)
// and JAX's lax twin bit for bit.
//
// Bound on this card: memory. The least work is to read the n payloads once
// and write the sum once, 4*(n+1)*D bytes (at n=8 and D = 1.09M, 39 MB:
// 11.7 us at 3.35 TB/s); the (n-1)*D adds take far less. Run step by step
// as on several cards, the ring moves about 3x the payload through landing
// slots in 2(n-1) dependent flag hops; on one card that buys nothing, so the
// design is one elementwise pass:
//
// - a block of 128 threads owns a tile of 512 consecutive elements, so a
//   tile never straddles a chunk and c and sign are the tile's;
// - each thread owns 4 elements of the tile: 4 consecutive ones (one 16-byte
//   load a rank) where the row stride is a multiple of 4 floats and the rows
//   are 16-byte aligned, else 4 scalars 128 apart (each warp load coalesced);
// - all n loads of a thread are independent and issued before the fold, so
//   each thread has up to 4n loads in flight;
// - rows are read in place through the stride (no padded copy; padded
//   index = flat index, elements >= D are masked), and the result is
//   written once. No slots, flags or cooperative launch.
//
// Ranks on distinct cards need a per-step fold between transfers (NCCL
// send/recv, or a ring of landing slots and release/acquire flags handed
// peer pointers); that design waits for a machine with several cards.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // 512 floats; a chunk is a multiple of 1024

// The rank whose value is folded k-th at an element of chunk c.
__device__ __forceinline__ int fold_rank(int c, int k, int sign, int n) {
  return ((c + k * sign) % n + n) % n;
}

// A thread's 4 elements of one rank's row: 4 consecutive floats at `i` (one
// 16-byte load), or 4 floats 128 apart from `i` (scalar loads; those at or
// past `size` read as 0 and are never stored).
template <bool kVector>
__device__ __forceinline__ float4 load4(const float* row, long long i, long long size) {
  if constexpr (kVector) {
    return __ldg(reinterpret_cast<const float4*>(row + i));
  } else {
    float v[kPerThread];
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const long long j = i + e * kThreads;
      v[e] = j < size ? __ldg(row + j) : 0.0f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float4 add4(float4 v, float4 acc) {
  return make_float4(__fadd_rn(v.x, acc.x), __fadd_rn(v.y, acc.y), __fadd_rn(v.z, acc.z),
                     __fadd_rn(v.w, acc.w));
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
    ring_all_reduce_kernel(const float* __restrict__ x, float* __restrict__ out,
                           long long stride, long long size, int n, long long chunk) {
  constexpr int kBatch = 8;  // loads issued before their folds
  const long long tile = static_cast<long long>(blockIdx.x) * kTile;
  const int c = static_cast<int>((tile / chunk) % n);
  const int sign = tile / (n * chunk) == 0 ? 1 : -1;
  const long long i = tile + (kVector ? kPerThread * threadIdx.x : threadIdx.x);
  if (i >= size) return;
  // With 16-byte loads the row stride is a multiple of 4 floats, so
  // i..i+3 lie inside a row even past D, and out holds a multiple of 4.
  float4 acc = load4<kVector>(x + static_cast<size_t>(c) * stride, i, size);
  for (int k0 = 1; k0 < n; k0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (k0 + j < n) {
        v[j] = load4<kVector>(x + static_cast<size_t>(fold_rank(c, k0 + j, sign, n)) * stride,
                              i, size);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (k0 + j < n) acc = add4(v[j], acc);
    }
  }
  if constexpr (kVector) {
    *reinterpret_cast<float4*>(out + i) = acc;
  } else {
    const float a[kPerThread] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      if (i + e * kThreads < size) out[i + e * kThreads] = a[e];
    }
  }
}

}  // namespace

// x: n rows `stride` floats apart, the first `size` of each used; out:
// `size` floats rounded up to a multiple of 4. `chunk` is the JAX
// geometry's chunk length (a multiple of 1024). `vector` takes the 16-byte
// path: the caller sets it only where x is 16-byte aligned, the stride is a
// multiple of 4 floats and every row can be read up to a multiple of 4.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ring_all_reduce_launch(const float* x, float* out, long long stride,
                                      long long size, int n, long long chunk, bool vector,
                                      void* stream) {
  const unsigned blocks = static_cast<unsigned>((size + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector) {
    ring_all_reduce_kernel<true><<<blocks, kThreads, 0, s>>>(x, out, stride, size, n, chunk);
  } else {
    ring_all_reduce_kernel<false><<<blocks, kThreads, 0, s>>>(x, out, stride, size, n, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
