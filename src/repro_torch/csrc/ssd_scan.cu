// ssd_scan: the Mamba2 SSD (state-space duality) chunked scan, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// (_ssd_kernel, l.30, and ssd_scan_pallas, l.78).  Per (batch, head), over
// chunks of q steps with L = the inclusive cumsum of dt * A in the chunk:
//
//   y_t  = sum_{s <= t} (C_t . B_s) exp(L_t - L_s) dt_s x_s
//          + exp(L_t) (C_t . S^T)
//   S'   = exp(L_q) S + sum_s exp(L_q - L_s) dt_s x_s (x) B_s
//
// with x (b, l, h, p), dt (b, l, h) f32, A (h,) f32, B and C (b, l, g, n),
// head h reading group h / (h / g).  y leaves in x's dtype (rounded once);
// the final state (b, h, p, n) is f32.  The wrapper pads l to a multiple of
// the chunk with dt = 0 identity steps (kernels/ssd_scan/ops.py).
//
// Bound: HBM bytes at the serving shapes (x and y dominate; ~0.05 ms at
// mamba2-1.3b's 16 x 512 prefill), with the operations close behind on the
// tensor cores.  This version runs plain f32 FMAs on operands read from
// shared memory, about 0.6 loads per FMA, so shared-memory loads and their
// latency bound it, far above the HBM bound; tensor cores and sharing C.B^T
// across the heads of a group are later work.  The design:
//
//   * One block per (head, batch).  The TPU grid walks the chunks in order
//     with the state in VMEM scratch; here the block walks them in a loop
//     and keeps S in shared memory for the whole sequence: the state never
//     goes to device memory until the end.
//   * Each chunk's x, B and C are staged in f32 (B and C transposed, so the
//     inner products read consecutive addresses), dt * A is cumsummed by one
//     warp in a fixed order, and the q x q matrix M is built in tiles of 32
//     rows: a tile of rows [t0, t0 + 32) only needs the columns s < t0 + 32,
//     which skips most of the upper triangle.  The footprint at q = 128,
//     p = 64, n = 128 is 216 KB (under the 227 KB opt-in limit).
//   * Entries above the diagonal are never multiplied by a mask: exp(L_t -
//     L_s) for s > t is exp of a positive number and overflows at large
//     |A dt|, and inf * 0 is NaN.  They are selected to 0 instead.
//   * The inner loops over k and s are unrolled by 4, so each thread has
//     several iterations' shared-memory loads in flight: with one 216 KB
//     block (8 warps) per SM, load latency, not throughput, is what stalls.
//   * Every sum runs in a fixed order and there are no atomics, so the same
//     input gives the same bits on every launch.
//
// Plain C interface, loaded through ctypes; the launch goes on the caller's
// stream and the function returns its cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16;      // threads along a tile's columns
constexpr int ROWS = 32;    // rows of M per tile: 2 per thread row
constexpr int MAX_Q = 128;  // chunk length
constexpr int MAX_P = 64;   // head dim: 4 columns per thread
constexpr int MAX_N = 128;  // state dim: 8 state rows per thread
constexpr int PT = MAX_P / TX;
constexpr int NT = MAX_N / TX;
constexpr int JT = MAX_Q / TX;
constexpr size_t SMEM_LIMIT = 232448;  // Hopper's opt-in limit per block

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Shared memory in floats (kernels/ssd_scan/ops.py::smem_bytes mirrors it):
// x [s][j], B^T and C^T [k][s], S^T [k][j], one M tile [r][s], then L, dt,
// exp(L) and the state-update weights.  Row strides are odd (q | 1, p | 1)
// so threads reading one column of consecutive rows hit distinct banks.
__host__ __device__ constexpr size_t smem_floats(int q, int p, int n) {
  return static_cast<size_t>(q) * p + 2 * static_cast<size_t>(n) * (q | 1) +
         static_cast<size_t>(n) * (p | 1) + static_cast<size_t>(ROWS) * (q | 1) +
         4 * static_cast<size_t>(q);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, T* __restrict__ y,
                float* __restrict__ state, int l, int h, int p, int g, int n,
                int q) {
  extern __shared__ float smem[];
  const int QS = q | 1, PS = p | 1;
  float* xs = smem;          // q * p
  float* bt = xs + q * p;    // n * QS
  float* ct = bt + n * QS;   // n * QS
  float* st = ct + n * QS;   // n * PS
  float* ms = st + n * PS;   // ROWS * QS
  float* Ls = ms + ROWS * QS;
  float* dts = Ls + q;
  float* eL = dts + q;
  float* ws = eL + q;

  const int hh = blockIdx.x, bi = blockIdx.y;
  const int gi = hh / (h / g);
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const float a_h = A[hh];
  const int pn = (p + TX - 1) / TX, nn = (n + TX - 1) / TX;

  // This thread's columns of x / y / S (j) and rows of S (k), clamped into
  // range so every load is valid; results at clamped indices are dropped.
  int jx[PT], kx[NT];
#pragma unroll
  for (int a = 0; a < PT; ++a) jx[a] = min(tx + TX * a, p - 1);
#pragma unroll
  for (int bb = 0; bb < NT; ++bb) kx[bb] = min(ty + TX * bb, n - 1);

  for (int i = tid; i < n * PS; i += THREADS) st[i] = 0.f;

  for (int c = 0; c < l / q; ++c) {
    const size_t row0 = static_cast<size_t>(bi) * l + static_cast<size_t>(c) * q;
    __syncthreads();  // the previous chunk is done with the staged inputs
    for (int i = tid; i < q * p; i += THREADS) {
      const int t = i / p, j = i - t * p;
      xs[i] = to_f32<T>(x[((row0 + t) * h + hh) * p + j]);
    }
    for (int i = tid; i < q * n; i += THREADS) {
      const int s = i / n, k = i - s * n;
      const size_t src = ((row0 + s) * g + gi) * n + k;
      bt[k * QS + s] = to_f32<T>(B[src]);
      ct[k * QS + s] = to_f32<T>(C[src]);
    }
    for (int i = tid; i < q; i += THREADS) dts[i] = dt[(row0 + i) * h + hh];
    __syncthreads();

    if (tid < 32) {
      // Inclusive cumsum of dt * A in a fixed order: each lane sums its run
      // of consecutive steps, then a shuffle scan adds the runs before it.
      const int per = (q + 31) / 32, lo = tid * per;
      float run = 0.f;
      for (int i = 0; i < per; ++i) {
        if (lo + i < q) {
          run += dts[lo + i] * a_h;
          Ls[lo + i] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid > 0) {
        for (int i = 0; i < per; ++i) {
          if (lo + i < q) Ls[lo + i] += prev;
        }
      }
    }
    __syncthreads();
    const float LQ = Ls[q - 1];
    for (int i = tid; i < q; i += THREADS) {
      eL[i] = expf(Ls[i]);
      ws[i] = expf(LQ - Ls[i]) * dts[i];
    }

    for (int t0 = 0; t0 < q; t0 += ROWS) {
      const int s_end = min(t0 + ROWS, q);  // this tile needs s <= t < s_end
      const int jn = (s_end - tx + TX - 1) / TX;
      int tg[2], sx[JT];
#pragma unroll
      for (int i = 0; i < 2; ++i) tg[i] = min(t0 + ty + TX * i, s_end - 1);
#pragma unroll
      for (int j = 0; j < JT; ++j) sx[j] = min(tx + TX * j, s_end - 1);

      // (1) M[t][s] = (C_t . B_s) exp(L_t - L_s) dt_s for s <= t, else 0.
      {
        float acc[2][JT];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < JT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const float* brow = bt + k * QS;
          const float* crow = ct + k * QS;
          const float c0 = crow[tg[0]], c1 = crow[tg[1]];
#pragma unroll
          for (int j = 0; j < JT; ++j) {
            if (j < jn) {
              const float bv = brow[sx[j]];
              acc[0][j] = fmaf(c0, bv, acc[0][j]);
              acc[1][j] = fmaf(c1, bv, acc[1][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = t0 + ty + TX * i;
          if (t >= s_end) continue;
#pragma unroll
          for (int j = 0; j < JT; ++j) {
            const int s = tx + TX * j;
            if (j < jn && s < s_end) {
              ms[(t - t0) * QS + s] =
                  s <= t ? acc[i][j] * expf(Ls[t] - Ls[s]) * dts[s] : 0.f;
            }
          }
        }
      }
      __syncthreads();

      // (2) y_t = M_t . x + exp(L_t) (C_t . S^T) for the tile's rows.
      {
        float acc[2][PT], inter[2][PT];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int a = 0; a < PT; ++a) acc[i][a] = inter[i][a] = 0.f;
        const float* m0 = ms + (tg[0] - t0) * QS;
        const float* m1 = ms + (tg[1] - t0) * QS;
#pragma unroll 4
        for (int s = 0; s < s_end; ++s) {
          const float mv0 = m0[s], mv1 = m1[s];
          const float* xr = xs + s * p;
#pragma unroll
          for (int a = 0; a < PT; ++a) {
            if (a < pn) {
              const float xv = xr[jx[a]];
              acc[0][a] = fmaf(mv0, xv, acc[0][a]);
              acc[1][a] = fmaf(mv1, xv, acc[1][a]);
            }
          }
        }
        if (c > 0) {  // the carried state is zero before the first chunk
#pragma unroll 4
          for (int k = 0; k < n; ++k) {
            const float c0 = ct[k * QS + tg[0]], c1 = ct[k * QS + tg[1]];
            const float* srow = st + k * PS;
#pragma unroll
            for (int a = 0; a < PT; ++a) {
              if (a < pn) {
                const float sv = srow[jx[a]];
                inter[0][a] = fmaf(c0, sv, inter[0][a]);
                inter[1][a] = fmaf(c1, sv, inter[1][a]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = t0 + ty + TX * i;
          if (t >= s_end) continue;
          const float e = eL[t];
          T* yrow = y + ((row0 + t) * h + hh) * p;
#pragma unroll
          for (int a = 0; a < PT; ++a) {
            const int j = tx + TX * a;
            if (a < pn && j < p) yrow[j] = from_f32<T>(acc[i][a] + e * inter[i][a]);
          }
        }
      }
      __syncthreads();  // the next tile rewrites M
    }

    // (3) S' = exp(L_q) S + sum_s (w_s x_s) (x) B_s, w_s = exp(L_q - L_s) dt_s.
    // Each thread owns the S entries (k = ty + 16 bb, j = tx + 16 a): it reads
    // and writes only those, after every reader of S in (2) has passed the
    // barrier above.
    {
      float acc[NT][PT];
#pragma unroll
      for (int bb = 0; bb < NT; ++bb)
#pragma unroll
        for (int a = 0; a < PT; ++a) acc[bb][a] = 0.f;
#pragma unroll 4
      for (int s = 0; s < q; ++s) {
        const float w = ws[s];
        const float* xr = xs + s * p;
        float xw[PT];
#pragma unroll
        for (int a = 0; a < PT; ++a) xw[a] = xr[jx[a]] * w;
#pragma unroll
        for (int bb = 0; bb < NT; ++bb) {
          if (bb < nn) {
            const float bv = bt[kx[bb] * QS + s];
#pragma unroll
            for (int a = 0; a < PT; ++a) {
              if (a < pn) acc[bb][a] = fmaf(xw[a], bv, acc[bb][a]);
            }
          }
        }
      }
      const float eQ = expf(LQ);
#pragma unroll
      for (int bb = 0; bb < NT; ++bb) {
        const int k = ty + TX * bb;
#pragma unroll
        for (int a = 0; a < PT; ++a) {
          const int j = tx + TX * a;
          if (k < n && j < p) st[k * PS + j] = eQ * st[k * PS + j] + acc[bb][a];
        }
      }
    }
  }
  __syncthreads();
  float* out = state + (static_cast<size_t>(bi) * h + hh) * p * n;
  for (int i = tid; i < p * n; i += THREADS) {
    const int j = i / n, k = i - j * n;
    out[i] = st[k * PS + j];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, void* y, void* state, int b, int l, int h,
                   int p, int g, int n, int q, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_LIMIT));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const size_t bytes = smem_floats(q, p, n) * sizeof(float);
  ssd_scan_kernel<T><<<dim3(static_cast<unsigned>(h), static_cast<unsigned>(b)),
                       THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), static_cast<float*>(state),
      l, h, p, g, n, q);
  return cudaGetLastError();
}

}  // namespace

// x: (b, l, h, p); dt: (b, l, h) f32; A: (h,) f32; B, C: (b, l, g, n);
// y: (b, l, h, p); state: (b, h, p, n) f32.  All contiguous; x, B, C and y
// share one dtype: 0 = float32, 1 = bfloat16.  l is a multiple of chunk.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* state, int dtype, int b, int l, int h,
                               int p, int g, int n, int chunk,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || b > 65535 || l < 1 || h < 1 || g < 1 || h % g != 0 ||
      p < 1 || p > MAX_P || n < 1 || n > MAX_N || chunk < 1 ||
      chunk > MAX_Q || l % chunk != 0 ||
      smem_floats(chunk, p, n) * sizeof(float) > SMEM_LIMIT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch<float>(x, dt, A, B, C, y, state, b, l, h, p, g, n, chunk, stream);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, dt, A, B, C, y, state, b, l, h, p, g, n, chunk, stream);
  }
  return static_cast<int>(err);
}
