// fed_reduce: weighted row-sum of a stacked federated update, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fed_reduce/fed_reduce.py
// (_fed_reduce_kernel, l.41, and fed_reduce_pallas, l.57):
//
//     out[c] = sum_i w[i] * (scales ? scales[i] : 1) * U[i, c]
//
// over a row-major (n, d) stack U in its wire dtype (f32, bf16 or int8), with
// f32 weights and an f32 result.  Every element is converted to f32 in
// registers; no dense f32 copy of a bf16 or int8 stack exists.  The int8
// wire's per-row scales fold into the row weight inside the kernel.
//
// Bound: HBM bytes.  The work is one multiply-add per stack element, so the
// kernel must move n*d*itemsize + 4n (+ 4n scales) + 4d bytes and the
// arithmetic is far below the card's rate.  The design keeps every stack
// byte read exactly once, in 16-byte vector loads where the row stride and
// base pointer allow it (4 f32, 8 bf16 or 16 int8 per load), and spreads the
// rows over enough blocks to keep all 132 SMs streaming:
//
//   * The TPU walks the row axis sequentially and carries the accumulator in
//     VMEM.  Blocks here run in no order, so the rows are cut into a fixed
//     number of splits (grid.y); each block reduces one split of rows for
//     one tile of columns (grid.x).
//   * Inside a block, threads.x run across columns (VEC columns per thread)
//     and threads.y across rows; each thread accumulates its rows in f32,
//     then the block folds threads.y in shared memory in a fixed tree order.
//     The d = 1 leaf (the bias) gets threads.x = 1 and 256 threads on rows,
//     so its rows are not serialized on one thread.
//   * Each block writes one f32 partial row to a (splits, d) scratch tensor
//     that the caller allocates; a second small kernel sums the partials in
//     split order.  With one split the first kernel writes the output.
//
// There are no float atomics: the same inputs give the same bits on every
// launch.  Rows and columns past the shape are masked; nothing is padded.
//
// Plain C interface, loaded through ctypes; the launch goes on the caller's
// stream and the function returns the cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

// VEC consecutive elements at p, converted to f32.  VEC > 1 is one 16-byte
// load, so p must be 16-byte aligned (the caller only picks VEC > 1 when the
// base pointer is aligned and d is a multiple of VEC).
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f32<T>(p[0]);
  } else {
    static_assert(sizeof(T) * VEC == 16, "vector loads are 16 bytes");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f32<T>(e[k]);
  }
}

// Block (blockDim.x, blockDim.y) reduces rows [split*rps, (split+1)*rps) for
// columns [blockIdx.x*blockDim.x*VEC, ...) into partial[split, :].
template <typename T, int VEC>
__global__ void fed_reduce_partial_kernel(const T* __restrict__ U,
                                          const float* __restrict__ w,
                                          const float* __restrict__ scales,
                                          float* __restrict__ partial,
                                          long long n, long long d,
                                          long long rows_per_split) {
  extern __shared__ float smem[];  // [blockDim.y][VEC][blockDim.x]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int TX = blockDim.x;
  const int TY = blockDim.y;
  const long long col0 = (static_cast<long long>(blockIdx.x) * TX + tx) * VEC;
  const long long split = blockIdx.y;
  const long long r_lo = split * rows_per_split;
  const long long r_hi = min(n, r_lo + rows_per_split);

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  if (col0 < d) {
    for (long long r = r_lo + ty; r < r_hi; r += TY) {
      float wr = __ldg(w + r);
      if (scales != nullptr) wr *= __ldg(scales + r);
      float x[VEC];
      load_f32<T, VEC>(U + r * d + col0, x);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wr, x[k], acc[k]);
    }
  }

  const int width = TX * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) smem[ty * width + k * TX + tx] = acc[k];
  __syncthreads();
  for (int s = TY / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        smem[ty * width + k * TX + tx] += smem[(ty + s) * width + k * TX + tx];
    }
    __syncthreads();
  }
  if (ty == 0 && col0 < d) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) partial[split * d + col0 + k] = smem[k * TX + tx];
  }
}

// out[c] = sum over splits of partial[s, c], in split order.
__global__ void fed_reduce_finalize_kernel(const float* __restrict__ partial,
                                           float* __restrict__ out,
                                           long long d, int splits) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += partial[static_cast<long long>(i) * d + c];
  out[c] = s;
}

template <typename T, int VEC>
cudaError_t launch_partial(const void* U, const float* w, const float* scales,
                           float* dst, long long n, long long d, int tx, int ty,
                           int splits, long long rows_per_split,
                           cudaStream_t stream) {
  const long long groups = (d + VEC - 1) / VEC;
  const dim3 grid(static_cast<unsigned>((groups + tx - 1) / tx),
                  static_cast<unsigned>(splits));
  const dim3 block(static_cast<unsigned>(tx), static_cast<unsigned>(ty));
  const size_t smem = static_cast<size_t>(tx) * ty * VEC * sizeof(float);
  fed_reduce_partial_kernel<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(U), w, scales, dst, n, d, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8.  vec: 1 or 16 / itemsize.
// tx * ty <= 1024, ty a power of two.  scales may be null.  partial must
// hold splits * d floats when splits > 1 (it is unused otherwise).
extern "C" int fed_reduce_launch(const void* U, int dtype, int vec,
                                 const float* w, const float* scales,
                                 float* out, float* partial, long long n,
                                 long long d, int tx, int ty, int splits,
                                 long long rows_per_split, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || d < 1 || splits < 1 || splits > 65535 || tx < 1 || ty < 1 ||
      tx * ty > 1024 || (ty & (ty - 1)) != 0 || rows_per_split < 1 ||
      (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* dst = splits > 1 ? partial : out;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 1) {
    err = launch_partial<float, 1>(U, w, scales, dst, n, d, tx, ty, splits, rows_per_split, stream);
  } else if (dtype == 0 && vec == 4) {
    err = launch_partial<float, 4>(U, w, scales, dst, n, d, tx, ty, splits, rows_per_split, stream);
  } else if (dtype == 1 && vec == 1) {
    err = launch_partial<__nv_bfloat16, 1>(U, w, scales, dst, n, d, tx, ty, splits, rows_per_split, stream);
  } else if (dtype == 1 && vec == 8) {
    err = launch_partial<__nv_bfloat16, 8>(U, w, scales, dst, n, d, tx, ty, splits, rows_per_split, stream);
  } else if (dtype == 2 && vec == 1) {
    err = launch_partial<int8_t, 1>(U, w, scales, dst, n, d, tx, ty, splits, rows_per_split, stream);
  } else if (dtype == 2 && vec == 16) {
    err = launch_partial<int8_t, 16>(U, w, scales, dst, n, d, tx, ty, splits, rows_per_split, stream);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((d + threads - 1) / threads);
  fed_reduce_finalize_kernel<<<blocks, threads, 0, stream>>>(partial, out, d, splits);
  return static_cast<int>(cudaGetLastError());
}
