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
// base pointer allow it (4 f32, 8 bf16 or 16 int8 per load), keeps enough
// of them in flight to cover the memory latency, and makes one launch:
//
//   * The TPU walks the row axis sequentially and carries the accumulator in
//     VMEM.  Blocks here run in no order, so the rows are cut into a fixed
//     number of splits (grid.y); each block reduces one split of rows for
//     one tile of columns (grid.x).
//   * Inside a block, threads.x run across columns (VEC columns per thread)
//     and threads.y across rows.  The row loop is unrolled by UNROLL = 8:
//     each thread issues eight independent loads (rows r, r + TY, ...,
//     r + 7 TY; predicated past the split's end) before it uses any, then
//     adds them in row order, so the sum order is the plain loop's; the
//     plan gives each thread about eight rows, so the whole stack is
//     requested at once.  The block folds threads.y in
//     shared memory in a fixed tree order.  The d = 1 leaf (the bias) gets
//     threads.x = 1 and 256 threads on rows, so its rows are not serialized
//     on one thread.
//   * Each block writes one f32 partial row to a (splits, d) scratch tensor
//     that the caller allocates and draws an integer ticket for its column
//     tile (an int atomicAdd with release and acquire semantics at device
//     scope, in place of two full fences; there are no float atomics).  The
//     block that draws the last ticket folds the tile's partials and writes
//     the output: threads.y row t folds the contiguous run of splits
//     [t * per, (t + 1) * per) in split order, reading with __ldcg (L2, not
//     the incoherent L1) sixteen 16-byte loads at a time, and the runs are
//     then added by the same fixed tree as the rows.  The fold order is
//     fixed by the plan, whichever block finishes last, so the same inputs
//     give the same bits on every launch.  The last block resets its
//     ticket to 0 for the next launch.  With one split the block writes the
//     output directly and draws no ticket.
//   * The tickets are one int32 per column tile in a buffer the caller
//     allocates and zeroes once per device.  Two launches in flight at once
//     on different streams would share it; the port launches on one stream.
//
// Rows and columns past the shape are masked; nothing is padded.
//
// Plain C interface, loaded through ctypes; the launch goes on the caller's
// stream and the function returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 8;  // independent row loads in flight per thread

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

// VEC consecutive elements of a row as loaded: one 16-byte vector when
// VEC > 1 (p must then be 16-byte aligned: the caller only picks VEC > 1
// when the base pointer is aligned and d is a multiple of VEC), else one
// element.
template <typename T, int VEC>
struct Raw {
  uint4 v;
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    static_assert(sizeof(T) * VEC == 16, "vector loads are 16 bytes");
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float operator[](int k) const {
    return to_f32<T>(reinterpret_cast<const T*>(&v)[k]);
  }
};

template <typename T>
struct Raw<T, 1> {
  T v;
  __device__ __forceinline__ void load(const T* __restrict__ p) { v = __ldg(p); }
  __device__ __forceinline__ float operator[](int) const { return to_f32<T>(v); }
};

__device__ __forceinline__ float row_weight(const float* __restrict__ w,
                                            const float* __restrict__ scales,
                                            long long r) {
  float wr = __ldg(w + r);
  if (scales != nullptr) wr *= __ldg(scales + r);
  return wr;
}

// The VEC partials at p (a 16-byte aligned f32 row segment when VEC > 1),
// through L2: other blocks wrote them during this launch.
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + k));
      x[k] = v.x;
      x[k + 1] = v.y;
      x[k + 2] = v.z;
      x[k + 3] = v.w;
    }
  }
}

// The column tile's ticket: atomicAdd with release and acquire semantics
// at device scope.  Release publishes this block's partial row (its writers
// passed a barrier before the one thread that draws); acquire makes every
// block that drew before visible to this one (the others read after the
// next barrier).
__device__ __forceinline__ int draw_ticket(int* ticket) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// Sums v over the block's TY rows into smem row 0 (TX * VEC floats), in a
// fixed order: first the rows inside a warp with a butterfly of shuffles
// (when TX < 32 a warp holds 32 / TX rows; every lane ends with the same
// bits), then the 8 warps' rows by a tree in shared memory.
template <int VEC>
__device__ __forceinline__ void block_fold(float (&v)[VEC], float* smem, int tx,
                                           int ty, int TX) {
  for (int o = 16; o >= TX; o >>= 1) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  const int t = ty * TX + tx;
  const int width = TX * VEC;
  if ((t & 31) < TX) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) smem[(t >> 5) * width + k * TX + tx] = v[k];
  }
  __syncthreads();
  for (int s = 4; s > 0; s >>= 1) {  // 8 warps of a 256-thread block
    if (ty < s) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        smem[ty * width + k * TX + tx] += smem[(ty + s) * width + k * TX + tx];
    }
    __syncthreads();
  }
}

// Block (blockDim.x, blockDim.y) reduces rows [split*rps, (split+1)*rps) for
// columns [blockIdx.x*blockDim.x*VEC, ...); the last block of each column
// tile folds the splits into out.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
fed_reduce_kernel(const T* __restrict__ U, const float* __restrict__ w,
                  const float* __restrict__ scales, float* __restrict__ out,
                  float* partial, int* tickets, long long n, long long d,
                  long long rows_per_split, int splits) {
  extern __shared__ float smem[];  // [blockDim.y][VEC][blockDim.x]
  __shared__ int is_last;
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
    for (long long r = r_lo + ty; r < r_hi; r += UNROLL * TY) {
      float wr[UNROLL];
      Raw<T, VEC> x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * TY < r_hi) {
          wr[u] = row_weight(w, scales, r + u * TY);
          x[u].load(U + (r + u * TY) * d + col0);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * TY < r_hi) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wr[u], x[u][k], acc[k]);
        }
      }
    }
  }

  block_fold<VEC>(acc, smem, tx, ty, TX);
  if (splits == 1) {
    if (ty == 0 && col0 < d) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[col0 + k] = smem[k * TX + tx];
    }
    return;
  }
  if (ty == 0 && col0 < d) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) partial[split * d + col0 + k] = smem[k * TX + tx];
  }
  __syncthreads();
  if (tx == 0 && ty == 0) is_last = draw_ticket(tickets + blockIdx.x) == splits - 1;
  __syncthreads();
  if (!is_last) return;

  // Fold: row ty takes the run of splits [ty * per, (ty + 1) * per) in
  // order, FOLD splits (sixteen 16-byte or scalar loads) in flight at a
  // time; then the runs fold in block_fold's order.
  constexpr int FOLD = VEC >= 4 ? 64 / VEC : 16;
  const int per = (splits + TY - 1) / TY;
  const int s_end = min(splits, (ty + 1) * per);
  float f[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) f[k] = 0.f;
  if (col0 < d) {
    for (int s = min(splits, ty * per); s < s_end; s += FOLD) {
      float x[FOLD][VEC];
#pragma unroll
      for (int j = 0; j < FOLD; ++j)
        if (s + j < s_end) load_partial<VEC>(partial + (s + j) * d + col0, x[j]);
#pragma unroll
      for (int j = 0; j < FOLD; ++j)
        if (s + j < s_end) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) f[k] += x[j][k];
        }
    }
  }
  block_fold<VEC>(f, smem, tx, ty, TX);
  if (ty == 0 && col0 < d) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[col0 + k] = smem[k * TX + tx];
  }
  if (tx == 0 && ty == 0) tickets[blockIdx.x] = 0;
}

template <typename T, int VEC>
cudaError_t launch(const void* U, const float* w, const float* scales,
                   float* out, float* partial, int* tickets, long long n,
                   long long d, int tx, int ty, int splits,
                   long long rows_per_split, cudaStream_t stream) {
  const long long groups = (d + VEC - 1) / VEC;
  const dim3 grid(static_cast<unsigned>((groups + tx - 1) / tx),
                  static_cast<unsigned>(splits));
  const dim3 block(static_cast<unsigned>(tx), static_cast<unsigned>(ty));
  const size_t smem = static_cast<size_t>(tx) * ty * VEC * sizeof(float);
  fed_reduce_kernel<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(U), w, scales, out, partial, tickets, n, d,
      rows_per_split, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8.  vec: 1 or 16 / itemsize.
// tx * ty == 256, ty a power of two.  scales may be null.  When splits > 1,
// partial must hold splits * d floats and tickets one zeroed int per column
// tile (ceil(ceil(d / vec) / tx)); both are unused otherwise.
extern "C" int fed_reduce_launch(const void* U, int dtype, int vec,
                                 const float* w, const float* scales,
                                 float* out, float* partial, int* tickets,
                                 long long n, long long d, int tx, int ty,
                                 int splits, long long rows_per_split,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || d < 1 || splits < 1 || splits > 65535 || tx < 1 || ty < 1 ||
      tx * ty != 256 || (ty & (ty - 1)) != 0 || rows_per_split < 1 ||
      (splits > 1 && (partial == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(U, w, scales, out, partial, tickets, n, d, tx, ty, splits, rows_per_split, stream);
  } else if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(U, w, scales, out, partial, tickets, n, d, tx, ty, splits, rows_per_split, stream);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(U, w, scales, out, partial, tickets, n, d, tx, ty, splits, rows_per_split, stream);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(U, w, scales, out, partial, tickets, n, d, tx, ty, splits, rows_per_split, stream);
  } else if (dtype == 2 && vec == 1) {
    err = launch<int8_t, 1>(U, w, scales, out, partial, tickets, n, d, tx, ty, splits, rows_per_split, stream);
  } else if (dtype == 2 && vec == 16) {
    err = launch<int8_t, 16>(U, w, scales, out, partial, tickets, n, d, tx, ty, splits, rows_per_split, stream);
  }
  return static_cast<int>(err);
}
