// causal_conv: Mamba2's depthwise causal conv, its bias and its SiLU, and the
// backward of the three, for Hopper.
//
// Replaces no TPU kernel.  The JAX package writes this chain as plain tensor
// code (src/repro/models/mamba2.py, _causal_conv) and XLA fuses it on the
// TPU.  Eager PyTorch runs the same chain as 14 forward and 31 backward ops
// a call, each one pass over device memory and one launch; this kernel is
// one pass forward and two launches backward:
//
//     y[b, t, c] = silu(sum_i x[b, t - (W - 1) + i, c] * w[i, c] + bias[c])
//
// over x (batch, len, channels) with the channels innermost, w (W, channels)
// with W <= 4 taps (tap W - 1 on the current step, rows before the start
// read as 0) and bias (channels).  x, w, bias and y share one dtype, f32 or
// bf16.
//
// Rounding: the plain chain's (kernels/causal_conv/ref.py), so the port
// keeps the JAX package's numbers.  Each tap's product is rounded to the
// dtype and added in tap order, each sum rounded to the dtype; then the bias
// is added and rounded; then SiLU in f32, rounded once.  The f32 products and
// sums are __fmul_rn / __fadd_rn, so nvcc does not contract them into FMAs
// the chain does not do.
//
// Bound: HBM bytes.  A call does 2 W + 4 flops per element, far below the
// card's rate; the forward must read x and write y (plus w and bias), the
// backward read x and dy and write dx (plus W + 1 partial rows of f32 per
// block of rows).  The design reads each byte about once and coalesced:
//
//   * Channels are the innermost axis.  A thread owns VEC consecutive
//     channels (one 8-byte load or store each: 4 bf16 or 2 f32; measured
//     about 10 % faster forward than 16-byte accesses, with half the
//     registers), so a warp covers 32 VEC contiguous channels of one row
//     and neighbouring threads read neighbouring addresses.
//   * A thread walks down a run of R consecutive steps of one sequence with
//     the last W - 1 rows in registers; the W - 1 rows before its run are
//     read again (from L2, mostly: the neighbouring run's block reads them
//     at about the same time).  The run is unrolled, so its loads are all
//     issued before they are used.  R is chosen by the caller from the
//     shapes (batch x len rows and the channels) so that the grid fills
//     the card's SMs several times over.
//   * The backward recomputes the pre-activation from x, w and bias (nothing
//     else is saved, so recomputation's memory does not grow), takes
//     dpre = dy * silu'(pre) in f32, and gives dx[t] = sum_i dpre[t + W - 1
//     - i] w[i] in f32, rounded once; each thread recomputes the W - 1
//     dpre rows after its run for that.  dw and dbias are sums over every
//     row: each thread sums its own run's rows in f32, the block folds its
//     threads' sums in shared memory in a fixed order into one f32 partial
//     row per tap and for the bias, and a second kernel sums the blocks'
//     partials in block order.  There are no float atomics: the same inputs
//     give the same bits on every launch.
//
// Plain C interface, loaded through ctypes; the launches go on the caller's
// stream and each function returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXW = 4;  // widest conv taken; narrower ones skip taps < MAXW - W
constexpr int THREADS = 256;

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

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision, as a PyTorch op on T tensors rounds its result.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// The machine word of VEC elements of T (2 to 8 bytes).
template <int BYTES>
struct Word;
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = unsigned int;
};
template <>
struct Word<2> {
  using type = unsigned short;
};

// VEC consecutive elements at p as f32 (one load; p aligned to VEC elements:
// the caller picks VEC > 1 only for aligned pointers and channels % VEC == 0).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  using W = typename Word<sizeof(T) * VEC>::type;
  const W raw = __ldg(reinterpret_cast<const W*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = to_f32<T>(e[k]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[VEC]) {
  using W = typename Word<sizeof(T) * VEC>::type;
  W raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) e[k] = from_f32<T>(v[k]);
  *reinterpret_cast<W*>(p) = raw;
}

template <int VEC>
__device__ __forceinline__ void zero(float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = 0.f;
}

// PyTorch's SiLU and its backward in f32 (aten's CUDA formulas).
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

__device__ __forceinline__ float silu_grad(float dy, float v) {
  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
  return dy * s * (1.f + v * (1.f - s));
}

// The pre-activation at one step from the window win (rows t - 3 .. t) in
// the chain's rounding: taps off .. MAXW - 1 in order, then the bias.
template <typename T, int VEC>
__device__ __forceinline__ void pre_act(const float (&win)[MAXW][VEC],
                                        const float (&wt)[MAXW][VEC],
                                        const float (&bv)[VEC], int off,
                                        float (&pre)[VEC]) {
  zero(pre);
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < off) continue;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      pre[k] = rnd<T>(__fadd_rn(pre[k], rnd<T>(__fmul_rn(win[i][k], wt[i][k]))));
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) pre[k] = rnd<T>(__fadd_rn(pre[k], bv[k]));
}

// Where a thread works: channel group g (channels g VEC ..), run `run` of R
// steps (sequence seq, steps t0 ..).  blockIdx.x runs over blocks of runs,
// blockIdx.y over tiles of channel groups (gridDim.y <= 65535).
struct Place {
  int g;
  long long run;
  long long seq;
  int t0;
  bool active;
};

template <int R>
__device__ __forceinline__ Place place(int groups, int runs_per_seq,
                                       long long runs) {
  Place p;
  p.g = blockIdx.y * blockDim.x + threadIdx.x;
  p.run = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  p.active = p.g < groups && p.run < runs;
  p.seq = p.active ? p.run / runs_per_seq : 0;
  p.t0 = p.active ? static_cast<int>(p.run % runs_per_seq) * R : 0;
  return p;
}

template <typename T, int VEC>
__device__ __forceinline__ void load_taps(const T* __restrict__ w,
                                          const T* __restrict__ bias, int c0,
                                          int channels, int off,
                                          float (&wt)[MAXW][VEC],
                                          float (&bv)[VEC]) {
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i >= off)
      load_vec<T, VEC>(w + static_cast<long long>(i - off) * channels + c0,
                       wt[i]);
    else
      zero(wt[i]);
  }
  load_vec<T, VEC>(bias + c0, bv);
}

template <typename T, int VEC, int R>
__global__ void __launch_bounds__(THREADS)
    causal_conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ y,
                           int len, int channels, int width, int runs_per_seq,
                           long long runs) {
  const int groups = (channels + VEC - 1) / VEC;
  const Place p = place<R>(groups, runs_per_seq, runs);
  if (!p.active) return;
  const int off = MAXW - width;
  const int c0 = p.g * VEC;
  float wt[MAXW][VEC], bv[VEC];
  load_taps<T, VEC>(w, bias, c0, channels, off, wt, bv);
  const long long base = p.seq * len * channels + c0;
  // win[j] holds step t - (MAXW - 1) + j; rows before the sequence are 0.
  float win[MAXW][VEC];
#pragma unroll
  for (int j = 0; j < MAXW - 1; ++j) {
    const int t = p.t0 - (MAXW - 1) + j;
    if (t >= 0 && j >= off)
      load_vec<T, VEC>(x + base + static_cast<long long>(t) * channels, win[j]);
    else
      zero(win[j]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = p.t0 + r;
    const bool live = t < len;
    if (live)
      load_vec<T, VEC>(x + base + static_cast<long long>(t) * channels,
                       win[MAXW - 1]);
    float pre[VEC], out[VEC];
    pre_act<T, VEC>(win, wt, bv, off, pre);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = silu(pre[k]);
    if (live) store_vec<T, VEC>(y + base + static_cast<long long>(t) * channels, out);
#pragma unroll
    for (int j = 0; j < MAXW - 1; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) win[j][k] = win[j + 1][k];
  }
}

// One f32 partial row per tap and one for the bias per block of runs:
// partial[blockIdx.x][k][c], k < width the taps, k == width the bias.
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(THREADS)
    causal_conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ bias,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ partial, int len, int channels,
                           int width, int runs_per_seq, long long runs) {
  __shared__ float red[(MAXW + 1) * VEC * THREADS];
  const int groups = (channels + VEC - 1) / VEC;
  const Place p = place<R>(groups, runs_per_seq, runs);
  const int off = MAXW - width;
  const int c0 = p.g * VEC;
  float dw[MAXW][VEC], db[VEC];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) zero(dw[i]);
  zero(db);
  if (p.active) {
    float wt[MAXW][VEC], bv[VEC];
    load_taps<T, VEC>(w, bias, c0, channels, off, wt, bv);
    const long long base = p.seq * len * channels + c0;
    const int end = min(p.t0 + R, len);
    float win[MAXW][VEC];
#pragma unroll
    for (int j = 0; j < MAXW - 1; ++j) {
      const int t = p.t0 - (MAXW - 1) + j;
      if (t >= 0 && j >= off)
        load_vec<T, VEC>(x + base + static_cast<long long>(t) * channels, win[j]);
      else
        zero(win[j]);
    }
    // acc[j] gathers dx of step s - (MAXW - 1) + j; at step s it takes
    // dpre[s] w[j], and acc[0] is then complete.
    float acc[MAXW][VEC];
#pragma unroll
    for (int j = 0; j < MAXW; ++j) zero(acc[j]);
#pragma unroll
    for (int r = 0; r < R + MAXW - 1; ++r) {
      const int s = p.t0 + r;
      float dpre[VEC];
      if (s < len) {
        load_vec<T, VEC>(x + base + static_cast<long long>(s) * channels,
                         win[MAXW - 1]);
        float g[VEC], pre[VEC];
        load_vec<T, VEC>(dy + base + static_cast<long long>(s) * channels, g);
        pre_act<T, VEC>(win, wt, bv, off, pre);
#pragma unroll
        for (int k = 0; k < VEC; ++k) dpre[k] = silu_grad(g[k], pre[k]);
        if (r < R) {
#pragma unroll
          for (int i = 0; i < MAXW; ++i) {
            if (i < off) continue;
#pragma unroll
            for (int k = 0; k < VEC; ++k) dw[i][k] += dpre[k] * win[i][k];
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k) db[k] += dpre[k];
        }
      } else {
        zero(dpre);
      }
#pragma unroll
      for (int j = 0; j < MAXW; ++j) {
        if (j < off) continue;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[j][k] += dpre[k] * wt[j][k];
      }
      const int t = s - (MAXW - 1);
      if (t >= p.t0 && t < end)
        store_vec<T, VEC>(dx + base + static_cast<long long>(t) * channels,
                          acc[0]);
#pragma unroll
      for (int j = 0; j < MAXW - 1; ++j)
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          acc[j][k] = acc[j + 1][k];
          win[j][k] = win[j + 1][k];
        }
      zero(acc[MAXW - 1]);
    }
  }
  // Fold the block's threads.y in order: red[(i VEC + k) TY + ty][tx].
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x,
            TY = blockDim.y;
#pragma unroll
  for (int i = 0; i <= MAXW; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      red[((i * VEC + k) * TY + ty) * TX + tx] = i < MAXW ? dw[i][k] : db[k];
  __syncthreads();
  const int tile0 = blockIdx.y * TX * VEC;
  const int per_tap = TX * VEC;
  for (int o = ty * TX + tx; o < (MAXW + 1) * per_tap; o += THREADS) {
    const int i = o / per_tap, rest = o % per_tap;
    const int q = rest / VEC, k = rest % VEC;  // thread q's element k
    const int c = tile0 + q * VEC + k;
    if (i < off || c >= channels) continue;
    float sum = 0.f;
    for (int u = 0; u < TY; ++u) sum += red[((i * VEC + k) * TY + u) * TX + q];
    partial[(static_cast<long long>(blockIdx.x) * (width + 1) + (i - off)) *
                channels + c] = sum;
  }
}

// dw (width, channels) and dbias (channels) in T: the blocks' partials
// summed in block order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    causal_conv_wsum_kernel(const float* __restrict__ partial,
                            T* __restrict__ dw, T* __restrict__ db, int parts,
                            int channels, int width) {
  const long long n = static_cast<long long>(width + 1) * channels;
  const long long o = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (o >= n) return;
  float sum = 0.f;
#pragma unroll 4
  for (int u = 0; u < parts; ++u) sum += __ldg(partial + u * n + o);
  if (o < static_cast<long long>(width) * channels)
    dw[o] = from_f32<T>(sum);
  else
    db[o - static_cast<long long>(width) * channels] = from_f32<T>(sum);
}

struct Grid {
  int runs_per_seq;
  long long runs;
  dim3 grid, block;
};

Grid grid_of(int vec, int rows, int batch, int len, int channels, int tx,
             int ty) {
  Grid g;
  g.runs_per_seq = (len + rows - 1) / rows;
  g.runs = static_cast<long long>(batch) * g.runs_per_seq;
  const int groups = (channels + vec - 1) / vec;
  g.grid = dim3(static_cast<unsigned>((g.runs + ty - 1) / ty),
                static_cast<unsigned>((groups + tx - 1) / tx));
  g.block = dim3(static_cast<unsigned>(tx), static_cast<unsigned>(ty));
  return g;
}

template <typename T, int VEC, int R>
cudaError_t fwd(const void* x, const void* w, const void* b, void* y,
                int batch, int len, int channels, int width, int tx, int ty,
                cudaStream_t stream) {
  const Grid g = grid_of(VEC, R, batch, len, channels, tx, ty);
  causal_conv_fwd_kernel<T, VEC, R><<<g.grid, g.block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), len, channels, width,
      g.runs_per_seq, g.runs);
  return cudaGetLastError();
}

template <typename T, int VEC, int R>
cudaError_t bwd(const void* x, const void* w, const void* b, const void* dy,
                void* dx, void* dw, void* db, float* partial, int batch,
                int len, int channels, int width, int tx, int ty,
                cudaStream_t stream) {
  const Grid g = grid_of(VEC, R, batch, len, channels, tx, ty);
  causal_conv_bwd_kernel<T, VEC, R><<<g.grid, g.block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(dy), static_cast<T*>(dx),
      partial, len, channels, width, g.runs_per_seq, g.runs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(width + 1) * channels;
  causal_conv_wsum_kernel<T><<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                               THREADS, 0, stream>>>(
      partial, static_cast<T*>(dw), static_cast<T*>(db),
      static_cast<int>(g.grid.x), channels, width);
  return cudaGetLastError();
}

bool valid(int vec, int rows, int batch, int len, int channels, int width,
           int tx, int ty) {
  if (batch < 1 || len < 1 || channels < 1 || width < 1 || width > MAXW ||
      tx < 1 || ty < 1 || tx * ty != THREADS || (vec > 1 && channels % vec))
    return false;
  const Grid g = grid_of(vec, rows, batch, len, channels, tx, ty);
  return g.grid.y <= 65535u && g.grid.x >= 1u &&
         (g.runs + ty - 1) / ty <= 0x7fffffffLL;
}

}  // namespace

// The instantiation of CALL<T, VEC, rows> (rows 4, 8 or 16).
#define CAUSAL_CONV_ROWS(CALL, T, VEC)                         \
  (rows == 4 ? &CALL<T, VEC, 4>                                \
             : rows == 8 ? &CALL<T, VEC, 8> : &CALL<T, VEC, 16>)

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 or 8 / itemsize (channels % vec
// == 0 and x, w, b, y aligned to 8 bytes).  rows: 4, 8 or 16 steps a
// thread.  tx * ty == 256.  x, y (batch, len, channels); w (width,
// channels), width <= 4; b (channels); all contiguous.
extern "C" int causal_conv_fwd_launch(const void* x, const void* w,
                                      const void* b, void* y, int dtype,
                                      int vec, int rows, int batch, int len,
                                      int channels, int width, int tx, int ty,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!valid(vec, rows, batch, len, channels, width, tx, ty) ||
      (rows != 4 && rows != 8 && rows != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && vec == 1)
    return static_cast<int>(CAUSAL_CONV_ROWS(fwd, float, 1)(
        x, w, b, y, batch, len, channels, width, tx, ty, stream));
  if (dtype == 0 && vec == 2)
    return static_cast<int>(CAUSAL_CONV_ROWS(fwd, float, 2)(
        x, w, b, y, batch, len, channels, width, tx, ty, stream));
  if (dtype == 1 && vec == 1)
    return static_cast<int>(CAUSAL_CONV_ROWS(fwd, __nv_bfloat16, 1)(
        x, w, b, y, batch, len, channels, width, tx, ty, stream));
  if (dtype == 1 && vec == 4)
    return static_cast<int>(CAUSAL_CONV_ROWS(fwd, __nv_bfloat16, 4)(
        x, w, b, y, batch, len, channels, width, tx, ty, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

// As the forward (x, w, b, dy, dx aligned to 8 bytes where vec > 1); dx like x, dw like w, db like b.  partial holds ceil(ceil(batch
// ceil(len / rows)) / ty) x (width + 1) x channels floats (the blocks of
// runs' partial rows); two launches: the rows, then their sum.
extern "C" int causal_conv_bwd_launch(const void* x, const void* w,
                                      const void* b, const void* dy, void* dx,
                                      void* dw, void* db, float* partial,
                                      int dtype, int vec, int rows, int batch,
                                      int len, int channels, int width, int tx,
                                      int ty, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!valid(vec, rows, batch, len, channels, width, tx, ty) ||
      (rows != 4 && rows != 8 && rows != 16) || partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && vec == 1)
    return static_cast<int>(CAUSAL_CONV_ROWS(bwd, float, 1)(
        x, w, b, dy, dx, dw, db, partial, batch, len, channels, width, tx, ty,
        stream));
  if (dtype == 0 && vec == 2)
    return static_cast<int>(CAUSAL_CONV_ROWS(bwd, float, 2)(
        x, w, b, dy, dx, dw, db, partial, batch, len, channels, width, tx, ty,
        stream));
  if (dtype == 1 && vec == 1)
    return static_cast<int>(CAUSAL_CONV_ROWS(bwd, __nv_bfloat16, 1)(
        x, w, b, dy, dx, dw, db, partial, batch, len, channels, width, tx, ty,
        stream));
  if (dtype == 1 && vec == 4)
    return static_cast<int>(CAUSAL_CONV_ROWS(bwd, __nv_bfloat16, 4)(
        x, w, b, dy, dx, dw, db, partial, batch, len, channels, width, tx, ty,
        stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
