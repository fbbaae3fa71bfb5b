// flash_attention: GQA attention forward (causal with a query offset), for
// Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (_flash_kernel, l.33,
// and flash_attention_pallas, l.90):
//
//     o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / g] * scale) @ v[b, j, h / g]
//
// for q (b, sq, h, d) and k, v (b, sk, kv, d), g = h / kv.  Key j is seen by
// query i when j < sk and, if causal, q_offset + i >= j.  Rounding follows
// the TPU kernel: q * scale is rounded back to the input dtype before Q.K^T,
// scores, the running max m and sum l and the accumulator stay f32, the
// probabilities are rounded to v's dtype before P.V, and the output is
// acc / max(l, 1e-37) in the input dtype.  Masked scores are NEG_INF =
// -0.7 * FLT_MAX, as on the TPU.
//
// Bound: operations at the serving shapes (prefill of 512 tokens does ~128
// flops per K/V byte per query block over the causal triangle, and the
// blocks re-read K/V from L2, not HBM).  This first version is plain f32
// FMAs from shared memory — no tensor cores, so it runs far below the
// card's bf16 peak; wgmma and TMA are a later step.  What the design does:
//
//   * A block takes 64 query rows of one (sequence, head) and streams 64-row
//     K/V tiles through shared memory, keeping the online-softmax state (m,
//     l) and the 64 x d accumulator in registers.  The TPU's sequential
//     grid axis over key blocks becomes this loop.
//   * Each of the 256 threads owns 4 query rows and, for Q.K^T, 4 key
//     columns; for P.V it owns the same 4 rows and d / 16 output columns,
//     so the softmax rescale needs no exchange between threads.  Row max
//     and sum reduce over the 16 threads of a row with shuffles.
//   * GQA reads K/V of head h / g for any g (3 at llama3.2-3b): nothing is
//     repeated in memory.  Causal blocks entirely above the diagonal are
//     never loaded; the key tail past sk is zero-filled and masked.
//
// Plain C interface, loaded through ctypes; the launch goes on the caller's
// stream and the function returns its cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 x 16
constexpr int PSTRIDE = BK + 1;

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

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// Max and sum over the 16 lanes that share a query row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
struct Layout {
  // K rows padded to an odd number of 32-bit words: the 16 lanes reading
  // one element of 16 different key rows hit 16 different banks.
  static constexpr int kstride = D + (sizeof(T) == 2 ? 2 : 1);
  static constexpr size_t q_bytes = static_cast<size_t>(BQ) * D * sizeof(T);
  static constexpr size_t v_bytes = static_cast<size_t>(BK) * D * sizeof(T);
  static constexpr size_t k_bytes =
      ((static_cast<size_t>(BK) * kstride * sizeof(T)) + 15) / 16 * 16;
  static constexpr size_t p_bytes = static_cast<size_t>(BQ) * PSTRIDE * sizeof(float);
  static constexpr size_t smem = q_bytes + v_bytes + k_bytes + p_bytes;
  static constexpr int dcols = D / 16;  // output columns per thread
};

// Stage rows [r0, r0 + 64) of a (rows, heads, D) slab (row stride `stride`
// elements) into shared memory with `dst_stride`; rows >= n_rows are zero.
// scale != 0 multiplies and rounds back to T (the query tile).
template <typename T, int D, bool SCALE>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, int dst_stride,
                                          const T* __restrict__ src,
                                          size_t stride, int r0, int n_rows,
                                          float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int c = threadIdx.x; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR;
    const int cc = c - r * CPR;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows) {
      raw = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * stride + cc * VEC));
      if constexpr (SCALE) {
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(to_f32<T>(e[i]) * scale);
      }
    }
    uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + r * dst_stride + cc * VEC);
    d32[0] = raw.x;
    d32[1] = raw.y;
    d32[2] = raw.z;
    d32[3] = raw.w;
  }
}

// Grid (query blocks, heads, batch).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
                 int h, int kvh, int causal, int q_offset, float scale) {
  using L = Layout<T, D>;
  constexpr int KS = L::kstride;
  constexpr int DC = L::dcols;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = reinterpret_cast<T*>(smem_raw + L::q_bytes);
  T* k_s = reinterpret_cast<T*>(smem_raw + L::q_bytes + L::v_bytes);
  float* p_s = reinterpret_cast<float*>(smem_raw + L::q_bytes + L::v_bytes + L::k_bytes);

  const int qb = blockIdx.x;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hh / (h / kvh);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qb * BQ;

  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(kvh) * D;
  const T* qb_ptr = q + static_cast<size_t>(bi) * sq * q_stride + static_cast<size_t>(hh) * D;
  const T* kb_ptr = k + static_cast<size_t>(bi) * sk * kv_stride + static_cast<size_t>(hk) * D;
  const T* vb_ptr = v + static_cast<size_t>(bi) * sk * kv_stride + static_cast<size_t>(hk) * D;

  load_tile<T, D, true>(q_s, D, qb_ptr, q_stride, q0, sq, scale);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int nk = (sk + BK - 1) / BK;
  // Key blocks strictly above the causal diagonal of this query block are
  // skipped: block kb is needed iff kb * BK <= q_offset + q0 + BQ - 1.
  const int n_blocks = causal ? min(nk, max(0, (q_offset + q0 + BQ - 1) / BK + 1)) : nk;
  for (int kb = 0; kb < n_blocks; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // previous tile fully consumed
    load_tile<T, D, false>(k_s, KS, kb_ptr, kv_stride, k0, sk, 0.f);
    load_tile<T, D, false>(v_s, D, vb_ptr, kv_stride, k0, sk, 0.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    if constexpr (sizeof(T) == 2) {
#pragma unroll 4
      for (int dd = 0; dd < D; dd += 2) {
        float2 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q_s + (ty + 16 * i) * D + dd));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k_s + (tx + 16 * j) * KS + dd));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          }
      }
    } else {
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = to_f32<T>(q_s[(ty + 16 * i) * D + dd]);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = to_f32<T>(k_s[(tx + 16 * j) * KS + dd]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < sk && (!causal || qpos >= kpos);
        s[i][j] = valid ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        p_s[(ty + 16 * i) * PSTRIDE + tx + 16 * j] = round_to<T>(p);
      }
      rs = row_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = to_f32<T>(v_s[c * D + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * PSTRIDE + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-37f);
    T* o = out + (static_cast<size_t>(bi) * sq + row) * q_stride + static_cast<size_t>(hh) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] * inv_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int sq, int sk, int h, int kvh, int causal,
                   int q_offset, float scale, cudaStream_t stream) {
  using L = Layout<T, D>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::smem));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid(static_cast<unsigned>((sq + BQ - 1) / BQ),
                  static_cast<unsigned>(h), static_cast<unsigned>(b));
  flash_fwd_kernel<T, D><<<grid, THREADS, L::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, h, kvh, causal,
      q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* out, int b, int sq, int sk, int h, int kvh,
                       int causal, int q_offset, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, sq, h, d); k, v: (b, sk, kv, d); out: (b, sq, h, d); contiguous,
// 16-byte aligned, h a multiple of kv.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int b, int sq, int sk, int h, int kvh,
                                      int d, int causal, int q_offset,
                                      float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || h < kvh || h % kvh != 0 ||
      h > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_d<float>(d, q, k, v, out, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, out, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
  }
  return static_cast<int>(err);
}
