// decode_attention: one query token per sequence against a ragged KV cache,
// for Hopper (flash-decoding).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py (_decode_kernel,
// l.31, and decode_attention_pallas, l.75):
//
//     o[b, h] = softmax_s(q[b, h] . k[b, s, h / g] * scale) @ v[b, s, h / g]
//
// over the rows s < lengths[b] of a (b, S, kv, d) cache, with g = h / kv
// query heads per KV head.  Rounding follows the TPU kernel: q * scale is
// rounded back to the input dtype before Q.K, the scores, the running max m
// and sum l and the accumulator stay f32, the probabilities are rounded to
// v's dtype before P.V, and the result is acc / max(l, 1e-37) in the input
// dtype.  A row with lengths[b] == 0 gets exact zeros.
//
// Bound: HBM bytes.  Each cache row is read once and used for g query heads,
// so a step does ~4g flops per byte of K/V — far under the card's ~295
// bf16 operations per byte.  The design reads only rows < lengths[b], each
// exactly once, in 16-byte vector loads, and spreads the reads over enough
// blocks to keep all SMs streaming:
//
//   * The TPU walks the cache blocks sequentially, carrying (m, l, acc) in
//     VMEM.  Here a block takes one (sequence, KV head, split) and walks its
//     split of the cache rows in tiles staged in shared memory; all g query
//     heads of the group share each staged tile (g = 3 at llama3.2-3b: no
//     power-of-two assumption anywhere).
//   * With one split the block normalizes and writes the output.  With
//     several, each block writes its unnormalized (acc, m, l) and a second
//     kernel combines the splits in split order as combine_partials does
//     (src/repro/kernels/decode_attention/ref.py:86).  No float atomics: the
//     same input gives the same bits on every launch.
//   * A split that starts past lengths[b] reads nothing and writes the
//     neutral partial (m = NEG_INF, l = 0, acc = 0).
//
// Plain C interface, loaded through ctypes; the launches go on the caller's
// stream and the function returns the cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP = 16;
constexpr int TILE_BYTES = 32 * 1024;

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

// f32 value of v rounded to T (the rounding the TPU kernel's astype does).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
struct Tile {
  // Cache rows staged per step: the largest power of two <= 64 whose K and
  // V tiles fit in 32 KiB (kernels/decode_attention/ops.py::tile_rows).
  static constexpr int raw = TILE_BYTES / (2 * D * static_cast<int>(sizeof(T)));
  static constexpr int rows = raw >= 64 ? 64 : raw;
  // K rows are padded to an odd number of 32-bit words, so lanes reading
  // one element of consecutive rows hit distinct banks.
  static constexpr int kstride = D + (sizeof(T) == 2 ? 2 : 1);
  static constexpr int acc_per_thread = (MAX_GROUP * D + THREADS - 1) / THREADS;
};

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

template <typename T, int D>
__host__ __device__ constexpr int smem_floats(int g) {
  // q (g*D f32), p (g*rows f32), m, l, alpha (g each), then K and V tiles.
  return align4(g * D) + align4(g * Tile<T, D>::rows) + 3 * align4(g);
}

template <typename T, int D>
size_t smem_bytes(int g) {
  using TL = Tile<T, D>;
  return smem_floats<T, D>(g) * sizeof(float) +
         static_cast<size_t>(TL::rows) * (TL::kstride + D) * sizeof(T) + 16;
}

// Dot product of an f32 q row (shared) with a K row (shared, type T).
template <typename T, int D>
__device__ __forceinline__ float qk_dot(const float* __restrict__ qr,
                                        const T* __restrict__ kr) {
  float a = 0.f;
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(kr);
#pragma unroll 8
    for (int i = 0; i < D / 2; ++i) {
      const float2 kf = __bfloat1622float2(k2[i]);
      a = fmaf(qr[2 * i], kf.x, a);
      a = fmaf(qr[2 * i + 1], kf.y, a);
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < D; ++i) a = fmaf(qr[i], to_f32<T>(kr[i]), a);
  }
  return a;
}

// Grid (splits, kv heads, batch).  Block: one split of one (sequence, KV
// head), all g query heads of the group.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int s_len, int kvh, int g,
                    int rows_per_split, int splits, float scale) {
  using TL = Tile<T, D>;
  constexpr int TK = TL::rows;
  constexpr int KS = TL::kstride;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CPR = D / VEC;         // 16-byte chunks per row
  constexpr int JMAX = TL::acc_per_thread;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* p_s = q_s + align4(g * D);
  float* m_s = p_s + align4(g * TK);
  float* l_s = m_s + align4(g);
  float* a_s = l_s + align4(g);
  T* v_s = reinterpret_cast<T*>(q_s + smem_floats<T, D>(g));  // 16-byte aligned
  T* k_s = v_s + TK * D;

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = min(max(lengths[bi], 0), s_len);
  const int lo = split * rows_per_split;
  const int hi = min(lo + rows_per_split, len);

  const size_t head0 = static_cast<size_t>(bi) * kvh * g + static_cast<size_t>(hk) * g;
  for (int i = tid; i < g * D; i += THREADS) {
    q_s[i] = round_to<T>(to_f32<T>(q[head0 * D + i]) * scale);
  }
  for (int i = tid; i < g; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  float acc[JMAX];
#pragma unroll
  for (int j = 0; j < JMAX; ++j) acc[j] = 0.f;
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(kvh) * D;
  const size_t base = static_cast<size_t>(bi) * s_len * row_stride + static_cast<size_t>(hk) * D;
  for (int t0 = lo; t0 < hi; t0 += TK) {
    const int n = min(TK, hi - t0);
    for (int c = tid; c < n * CPR; c += THREADS) {
      const int r = c / CPR;
      const int cc = c - r * CPR;
      const size_t off = base + static_cast<size_t>(t0 + r) * row_stride + cc * VEC;
      const uint4 kr = __ldg(reinterpret_cast<const uint4*>(k + off));
      const uint4 vr = __ldg(reinterpret_cast<const uint4*>(v + off));
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + r * KS + cc * VEC);
      kd[0] = kr.x;
      kd[1] = kr.y;
      kd[2] = kr.z;
      kd[3] = kr.w;
      *reinterpret_cast<uint4*>(v_s + r * D + cc * VEC) = vr;
    }
    __syncthreads();

    // Scores of every (head, row) pair of the tile.
    for (int i = tid; i < g * TK; i += THREADS) {
      const int hh = i / TK;
      const int r = i - hh * TK;
      p_s[i] = r < n ? qk_dot<T, D>(q_s + hh * D, k_s + r * KS) : NEG_INF;
    }
    __syncthreads();

    // Online softmax, one warp per query head.
    for (int hh = warp; hh < g; hh += WARPS) {
      float* ps = p_s + hh * TK;
      float mx = NEG_INF;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, ps[r]);
      mx = warp_max(mx);
      const float m_old = m_s[hh];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < TK; r += 32) {
        const float p = r < n ? expf(ps[r] - m_new) : 0.f;
        sum += p;
        ps[r] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[hh] = alpha;
        l_s[hh] = l_s[hh] * alpha + sum;
        m_s[hh] = m_new;
      }
    }
    __syncthreads();

    // acc[h, d] = acc * alpha[h] + sum_r p[h, r] * v[r, d].
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int i = tid + j * THREADS;
      if (i < g * D) {
        const int hh = i / D;
        const int dd = i - hh * D;
        const float* ps = p_s + hh * TK;
        float a = acc[j] * a_s[hh];
        for (int r = 0; r < n; ++r) a = fmaf(ps[r], to_f32<T>(v_s[r * D + dd]), a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int i = tid + j * THREADS;
      if (i < g * D) {
        const float l = fmaxf(l_s[i / D], 1e-37f);
        out[head0 * D + i] = from_f32<T>(acc[j] / l);
      }
    }
    return;
  }
  const size_t part = (static_cast<size_t>(bi) * kvh + hk) * splits + split;
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    const int i = tid + j * THREADS;
    if (i < g * D) part_o[part * g * D + i] = acc[j];
  }
  for (int i = tid; i < g; i += THREADS) {
    part_ml[(part * g + i) * 2] = m_s[i];
    part_ml[(part * g + i) * 2 + 1] = l_s[i];
  }
}

// out[b, h, d] from the split partials, in split order.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, long long total,
                                      int g, int d, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long gd = static_cast<long long>(g) * d;
  const long long group = i / gd;  // (b, kv head)
  const int hh = static_cast<int>((i - group * gd) / d);
  const int dd = static_cast<int>(i - group * gd - static_cast<long long>(hh) * d);
  const long long p0 = group * splits;
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_ml[((p0 + s) * g + hh) * 2]);
  float l = 0.f;
  float o = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(part_ml[((p0 + s) * g + hh) * 2] - m);
    l += part_ml[((p0 + s) * g + hh) * 2 + 1] * w;
    o += part_o[(p0 + s) * gd + static_cast<long long>(hh) * d + dd] * w;
  }
  out[i] = from_f32<T>(o / fmaxf(l, 1e-37f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part_o,
                   float* part_ml, int b, int s, int kvh, int g,
                   int rows_per_split, int splits, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(g);
  static size_t smem_set = 48 * 1024;  // the default dynamic limit
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(kvh),
                  static_cast<unsigned>(b));
  decode_split_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part_o,
      part_ml, s, kvh, g, rows_per_split, splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = static_cast<long long>(b) * kvh * g * D;
  const int threads = 256;
  decode_combine_kernel<T><<<static_cast<unsigned>((total + threads - 1) / threads),
                             threads, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(out), total, g, D, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const int* lengths, void* out, float* part_o,
                       float* part_ml, int b, int s, int kvh, int g,
                       int rows_per_split, int splits, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, out, part_o, part_ml, b, s, kvh, g, rows_per_split, splits, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, part_o, part_ml, b, s, kvh, g, rows_per_split, splits, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, part_o, part_ml, b, s, kvh, g, rows_per_split, splits, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, part_o, part_ml, b, s, kvh, g, rows_per_split, splits, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, out, part_o, part_ml, b, s, kvh, g, rows_per_split, splits, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, kv*g, d); k, v: (b, s, kv, d), contiguous, 16-byte aligned;
// lengths: (b,) int32; out: (b, kv*g, d).  dtype: 0 = float32, 1 =
// bfloat16.  part_o (b, kv, splits, g, d) and part_ml (b, kv, splits, g, 2)
// are f32 scratch, needed only when splits > 1.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       void* out, float* part_o,
                                       float* part_ml, int dtype, int b,
                                       int s, int kvh, int g, int d,
                                       int rows_per_split, int splits,
                                       float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || s < 1 || kvh < 1 || g < 1 || g > MAX_GROUP ||
      rows_per_split < 1 || splits < 1 || splits > 65535 || kvh > 65535 ||
      b > 65535 || (splits > 1 && (part_o == nullptr || part_ml == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_d<float>(d, q, k, v, lengths, out, part_o, part_ml, b, s, kvh, g, rows_per_split, splits, scale, stream);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, lengths, out, part_o, part_ml, b, s, kvh, g, rows_per_split, splits, scale, stream);
  }
  return static_cast<int>(err);
}
