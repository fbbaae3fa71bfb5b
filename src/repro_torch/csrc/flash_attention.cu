// flash_attention: GQA attention forward (causal with a query offset) and
// its backward, for Hopper.  Two forward kernels, chosen by dtype and head
// width before any launch: flash_fwd_wgmma_kernel (bf16 at d = 64 or 128,
// tensor cores) and flash_fwd_kernel (f32, and bf16 at d = 16, 32, 256;
// plain FMAs).  Either also writes each row's log-sum-exp (lse, (b, h, sq)
// f32) when the caller passes a buffer for it; serving passes none.
//
// Both replace the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (_flash_kernel, l.33,
// and flash_attention_pallas, l.90):
//
//     o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / g] * scale) @ v[b, j, h / g]
//
// for q (b, sq, h, d) and k, v (b, sk, kv, d), g = h / kv.  Key j is seen by
// query i when j < sk and, if causal, q_offset + i >= j.  Rounding follows
// the TPU kernel: q * scale is rounded back to the input dtype before Q.K^T,
// scores, the running max m and sum l and the accumulator stay f32, l sums
// the f32 probabilities, the probabilities are rounded to v's dtype before
// P.V, and the output is acc / max(l, 1e-37) (as acc times the row's one
// reciprocal) in the input dtype.  Masked scores are NEG_INF = -0.7 *
// FLT_MAX, selected (never added), as on the TPU.
//
// Bound: at the serving prefill (16 x 512, causal) reading q, k, v and
// writing o once takes 0.040 ms at 3.35 TB/s and the causal triangle's
// flops 0.026 ms (llama3.2-3b) or 0.017 ms (zamba2) at the bf16
// tensor-core peak, so only a kernel that keeps its products on the tensor
// cores and its K/V re-reads in L2 and shared memory can approach it.
//
// flash_fwd_wgmma_kernel (bf16, d = 64 or 128).  Deliberately the simple
// Hopper design: every warpgroup both loads and computes, no warp
// specialisation, no persistent blocks.
//
//   * One block per (query tile, query head, sequence), with one warpgroup
//     of 128 threads per 64 query rows: two at d = 128 (128-row tiles),
//     sharing each K/V tile, which halves the K/V traffic per row; one at
//     d = 64, where five blocks fit an SM.  The heaviest causal tiles are
//     launched first.  A warpgroup skips the key tiles that lie wholly
//     above its own rows' diagonal (and all of them if its rows lie past
//     sq).  About 97 KB of shared memory at d = 128 and at most 128
//     registers a thread let two blocks, four warpgroups, share an SM, so
//     one warpgroup's softmax overlaps another's wgmma.
//   * TMA loads Q and 64-key K/V tiles into a two-stage ring, each stage
//     with its own mbarrier (expect_tx) and its own phase parity (the tile
//     index / 2); one thread issues every load.  The tensor maps are 4-D
//     over the model's (b, s, h, d) layout, so rows past sq or sk come back
//     zero-filled and GQA reads KV head h / g by coordinate: nothing is
//     repeated or padded in memory.  Causal tiles wholly above the
//     diagonal are never loaded.  cuTensorMapEncodeTiled comes through the
//     runtime's driver entry point, so the build needs no -lcuda.
//   * S = Q.K^T is wgmma m64n64k16 over d / 16 steps, Q (A) and K (B) both
//     K-major from 128B-swizzled shared memory.
//   * The online softmax runs on the accumulator fragments in registers:
//     each thread holds 2 rows x 16 keys, so the row max and sum take two
//     shuffles within a quad; each exponential is one FFMA (the log2 e
//     scale folded in) and one ex2.approx on the SFU (2 ulp; the TPU's exp
//     is an approximation too).  Only the diagonal tile and the sk tail
//     tile are masked.  P is rounded to bf16 in registers, where the
//     accumulator's layout is already wgmma's A-register layout, and O +=
//     P.V is wgmma m64n{d}k16 with P as the register A operand and V as B
//     from shared memory, MN-major (keys are the K dimension, d is
//     contiguous: the transpose bit, which bf16 allows).
//   * O is written from registers with per-row bounds: rows >= sq are never
//     written.  It is acc times 1 / max(l, 1e-37), one division per row,
//     as the plain-FMA kernel does.
//
// What made it hard, and what the code does about it:
//   1. The 128-byte swizzle limits a TMA box's inner extent to 128 bytes,
//      and a d = 128 bf16 row is 256: every tile loads as d / 64 boxes of
//      64 columns (64 or 128 rows, stacked), so the K-steps of Q.K^T
//      walk two boxes (the start address moves one box for steps 4..7) and
//      P.V's B descriptor steps 8 KB (its leading byte offset) from the
//      first 64 columns of d to the next.
//   2. Swizzled tiles need 1024-byte aligned bases: the kernel aligns the
//      dynamic shared memory base itself.  The descriptors match the TMA
//      swizzle: 128B layout, 1024-byte stride between 8-row groups, K-steps
//      of 32 bytes inside the atom (K-major) or 2 KB (16 keys, MN-major).
//   3. Q is scaled and rounded after TMA lands it, by a pass over shared
//      memory; that pass writes through the generic proxy, so every thread
//      runs fence.proxy.async.shared::cta before the barrier that precedes
//      the first wgmma reading Q.
//   4. wgmma.fence comes before each group of wgmmas (the accumulators and
//      P were written by ordinary instructions), commit_group / wait_group
//      0 before the softmax reads S and before O is rescaled or stored, and
//      empty asm statements pin the accumulator registers around them.
//   5. Each ring stage has its own mbarrier and parity; a stage is reloaded
//      only after every warp of both warpgroups has waited on its wgmmas and
//      passed a barrier.
//   6. More than 48 KB of dynamic shared memory needs cudaFuncSetAttribute.
//
// flash_fwd_kernel (everything else the wrapper takes) is plain f32 FMAs
// from shared memory — f32 on tensor cores would be TF32, which the f32
// tolerance (3e-5) does not allow:
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
// The backward.  There is no Pallas backward kernel to replace: the
// reference differentiates its lowerable chunked path,
// src/repro/kernels/flash_attention/ref.py:49 (attention_chunked), with
// jax.grad.  Given q, k, v, the forward's o and lse, and dO:
//
//     P = exp(S - lse), D = rowsum(dO o O), dV = P^T dO, dP = dO V^T,
//     dS = P o (dP - D), dK = dS^T (q scale), dQ = scale dS K,
//
// with dK and dV summed over the g query heads of each KV head.  No float
// atomics in a run-dependent order: each output has one writer or is
// summed in a fixed order, so the backward is bitwise repeatable like the
// forward.
//
// Bound at llama3.2-3b's training shape (b = 1, sq = sk = 4096, 24/8 heads
// of 128, causal, bf16): 10 d flops per causal pair per head, 10 x 128 x
// 8.39 M x 24 = 257.8 GFLOP, 0.261 ms at 989 TFLOP/s; its bytes (q, o, dO,
// dQ at 25.2 MB, k, v, dK, dV at 8.4 MB, lse and D) ~135 MB, 0.040 ms at
// 3.35 TB/s: the flops set it, so the products must run on wgmma.
//
// bf16 at d = 64, 128, every training path's route (wg_bwd below): dQ
// summed across key tiles, 5 products per tile pair as the bound counts
// them.  Three launches:
//   * flash_bwd_prep_kernel writes D = rowsum(dO o O), lse log2 e (both
//     padded to 64-row tiles, so a tile's is one aligned 256-byte bulk
//     copy), q * scale rounded to bf16 (the forward's rounding, so the
//     product kernel loads it by TMA as it is) and zeroes a turn counter
//     per (sequence, head, 64-row query tile).
//   * flash_bwd_fused_wgmma_kernel: one block of 384 threads per (128-key
//     tile, KV head, sequence), key tile 0 of every head first.  Two
//     consumer warpgroups own 64 keys each, their K and V tiles loaded
//     once, and dK and dV in f32 registers (128 a thread at d = 128;
//     setmaxnreg raises them to 240 and drops the producer to 24).  One
//     producer thread streams (q * scale, dO, lse, D) of every query tile
//     that sees the keys, the last tile first and the group's heads inner,
//     through a 2-stage ring with a full mbarrier (expect_tx) and an empty
//     one (one arrival per consumer warp) per stage.  Per tile: S^T = K (q
//     scale)^T and dP^T = V dO^T on SS wgmma m64n64k16 (both K-major from
//     the 128B-swizzled TMA tiles), the exponentials of P^T while dP^T's
//     group still runs, dS^T = P^T (dP^T - D), both rounded to bf16 in
//     registers, then dV += P^T dO and dK += dS^T (q scale) on RS wgmma
//     (tiles read MN-major) and dQ's partial dS K on SS wgmma from dS^T
//     written to shared memory in the swizzled layout (both operands
//     MN-major: the two transpose bits; at d = 128 each warpgroup takes 64
//     columns over all 128 keys, at d = 64 all columns over its own keys).
//     The partial goes to shared memory in accumulator-fragment order and
//     a reducer thread of the producer warpgroup adds it into an f32 sum
//     in global memory with one bulk copy (cp.reduce.async.bulk .add.f32),
//     in key-tile order: it waits until the query tile's turn counter
//     equals its key tile, then raises it once the add has completed.
//     Key tile 0, every query tile's first contributor, stores instead.
//     Every block walks the query tiles in the same order, so key tile kt
//     reaches a tile when kt - 1 does: the turns cost one add's latency
//     per tile, not a chain of blocks.
//     Every product runs also where a warpgroup's keys are past sk or
//     across the diagonal: a branch around a wgmma makes ptxas serialise
//     them, and those tiles cross an edge, so their entries are 0.
//   * flash_bwd_dq_convert_kernel: dQ = bf16(scale sum), its rows written
//     whole through shared memory.
//   * Masked entries (causal, keys past sk, rows past sq, where TMA's
//     zero fill gives S = 0 and the padded lse 0, so exp would be 1) are
//     selected to 0, only in tiles that cross an edge.
//   * The smem request is over half an SM's, so one block holds an SM: two
//     blocks' consumers could not both raise their registers.
//   * The turns need every block of key tile kt - 1 dispatched before key
//     tile kt's: the grid's linear order (KV head fastest, then key tile)
//     gives that.
// f32 and the other widths run on plain f32 FMAs (flash_bwd_dkdv_kernel,
// flash_bwd_dq_kernel: a dK/dV kernel over key tiles and a dQ kernel over
// query tiles, after a pass that computes D).
//
// Plain C interface, loaded through ctypes; each launch goes on the caller's
// stream and each entry point returns its cudaError_t.

#include <cuda.h>  // CUtensorMap and its enums; no driver symbol is linked
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
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int h, int kvh,
                 int causal, int q_offset, float scale) {
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
    // The row's log-sum-exp for the backward (every lane of the row holds m
    // and l after the reductions).
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(bi) * h + hh) * sq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int sq, int sk, int h, int kvh,
                   int causal, int q_offset, float scale,
                   cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, h, kvh,
      causal, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* out, float* lse, int b, int sq, int sk, int h,
                       int kvh, int causal, int q_offset, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// --------------------------------------------------------------------------
// flash_fwd_wgmma_kernel: bf16 on the tensor cores (wgmma, TMA, mbarriers).

namespace tc {

constexpr int WG_ROWS = 64;     // query rows per warpgroup (one wgmma M)
constexpr int BN = 64;          // keys per tile
constexpr int STAGES = 2;       // K/V ring
constexpr int BOX_COLS = 64;    // 128 bytes of bf16: the 128B swizzle's widest box
constexpr uint32_t BOX_BYTES = 64 * 128;  // one 64-row x 64-column box
constexpr uint32_t SW_ROWS8 = 1024;       // 8 swizzled 128-byte rows

template <int D>
struct Layout {
  // Warpgroups per block, each taking 64 query rows and sharing each K/V
  // tile: two at d = 128, where sharing halves the K/V traffic per row;
  // one at d = 64, where five single-warpgroup blocks fit an SM.
  static constexpr int wgs = D == 128 ? 2 : 1;
  static constexpr int bm = wgs * WG_ROWS;  // query rows per block
  static constexpr int threads = wgs * 128;
  static constexpr int boxes = D / BOX_COLS;
  static constexpr uint32_t q_box = wgs * BOX_BYTES;  // bm rows x 64 columns
  static constexpr uint32_t q_tile = boxes * q_box;   // bm rows x D bf16
  static constexpr uint32_t tile = boxes * BOX_BYTES;  // 64 keys x D bf16
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t k_off = q_off + q_tile;
  static constexpr uint32_t v_off = k_off + STAGES * tile;
  static constexpr uint32_t bar_off = v_off + STAGES * tile;  // q, kv[STAGES]
  static constexpr size_t smem = bar_off + 8 * (1 + STAGES) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory at dst; completion is counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that owns it.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// A wgmma shared-memory descriptor for a 128B-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = 128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx: ~2 ulp; 0 for x = -inf).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// D (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), both bf16 from shared
// memory through 128B-swizzled descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, bf16 from
// shared memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128, bf16 from
// shared memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_m64n64_tb(o, a, db);
  } else {
    wgmma_rs_m64n128_tb(o, a, db);
  }
}

// K or V tile `tile` (64 keys x D) of KV head hk into ring stage `stage`.
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, uint32_t k_s,
                                        uint32_t v_s, uint32_t bar, int tile,
                                        int stage, int hk, int bi) {
  using L = Layout<D>;
  const uint32_t b = bar + 8u * (1 + stage);
  mbar_expect_tx(b, 2 * L::tile);
#pragma unroll
  for (int x = 0; x < L::boxes; ++x) {
    tma_load_4d(k_s + stage * L::tile + x * BOX_BYTES, k_map, b, x * BOX_COLS, hk,
                tile * BN, bi);
    tma_load_4d(v_s + stage * L::tile + x * BOX_BYTES, v_map, b, x * BOX_COLS, hk,
                tile * BN, bi);
  }
}

// Grid (query tiles of L::bm rows, heads, batch); g = h / kv.  Warpgroup w
// takes rows [64 w, 64 w + 64) of the tile.
template <int D>
__global__ void __launch_bounds__(Layout<D>::threads, 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                       int sq, int sk, int h, int g, int causal, int q_offset,
                       float scale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base + L::q_off;
  const uint32_t k_s = base + L::k_off;
  const uint32_t v_s = base + L::v_off;
  const uint32_t bar = base + L::bar_off;  // q; kv stage s at bar + 8 (1 + s)

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // this thread's warpgroup
  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hh / g;
  const int q0 = qb * L::bm;
  const int wq0 = q0 + wg * WG_ROWS;  // this warpgroup's first row
  const int nk = (sk + BN - 1) / BN;
  // Key tiles strictly above the causal diagonal of the block's last row
  // below sq are never loaded: tile kb is needed iff kb * BN <= q_offset +
  // that row.  A warpgroup computes only the tiles its own rows need (none
  // if they all lie past sq; a tile above its diagonal would add exact
  // zeros), and the last warpgroup with rows needs every loaded tile, so
  // no load is left in flight when the block exits.
  const int last_row = min(q0 + L::bm, sq) - 1;
  const int n_tiles = causal ? min(nk, (q_offset + last_row) / BN + 1) : nk;
  const int wg_last = min(wq0 + WG_ROWS, sq) - 1;
  const int wg_tiles = wq0 >= sq ? 0
                       : causal ? min(nk, (q_offset + wg_last) / BN + 1) : nk;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(bar + 8u * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, L::q_tile);
#pragma unroll
    for (int x = 0; x < L::boxes; ++x)
      tma_load_4d(q_s + x * L::q_box, &q_map, bar, x * BOX_COLS, hh, q0, bi);
    for (int t = 0; t < min(STAGES, n_tiles); ++t)
      load_kv<D>(&k_map, &v_map, k_s, v_s, bar, t, t, hk, bi);
  }

  // q * scale, rounded back to bf16, in place (the swizzle permutes whole
  // 16-byte chunks, so an elementwise pass ignores it).
  mbar_wait(bar, 0);
  {
    uint4* qv = reinterpret_cast<uint4*>(smem + L::q_off);
    for (int i = tid; i < static_cast<int>(L::q_tile / 16); i += L::threads) {
      uint4 v = qv[i];
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(e[j]);
        e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      qv[i] = v;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // Accumulator fragment of wgmma m64nN: thread (warp w of its warpgroup,
  // lane l) holds rows r0 = 16 w + l / 4 and r0 + 8 of the warpgroup's 64;
  // element i sits in row r0 + 8 ((i >> 1) & 1) and column 8 (i >> 2) +
  // 2 (l & 3) + (i & 1).
  const int lane = tid & 31;
  const int r0 = ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  const int qpos0 = q_offset + wq0 + r0;
  const int qpos1 = qpos0 + 8;
  const uint32_t q_wg = q_s + wg * BOX_BYTES;  // its rows in each Q box

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int stage = kb & 1;
    if (kb < wg_tiles) {  // uniform across the warpgroup
      mbar_wait(bar + 8u * (1 + stage), (kb >> 1) & 1);
      __syncwarp();
      const uint32_t ks = k_s + stage * L::tile;
      const uint32_t vs = v_s + stage * L::tile;

      // S = (Q * scale) . K^T: d / 16 K-steps of 32 bytes, four per 128-byte
      // swizzle atom, then on to the next 64 columns' box.
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) pin(s[i]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t kc = (kk & 3) * 32;  // 16 columns into the atom
        wgmma_ss_m64n64(s, sw128_desc(q_wg + (kk >> 2) * L::q_box + kc, 16, SW_ROWS8),
                        sw128_desc(ks + (kk >> 2) * BOX_BYTES + kc, 16, SW_ROWS8), 1);
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) pin(s[i]);

      // Masking by selection, on the diagonal tile and the sk tail only.
      const int k0 = kb * BN;
      if (k0 + BN > sk || (causal && k0 + BN - 1 > q_offset + wq0)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kpos = k0 + (i >> 2) * 8 + c2 + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          const bool valid = kpos < sk && (!causal || qpos >= kpos);
          s[i] = valid ? s[i] : NEG_INF;
        }
      }

      // Online softmax: row max and sum over the 4 threads of a quad.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) {
          mx1 = fmaxf(mx1, s[i]);
        } else {
          mx0 = fmaxf(mx0, s[i]);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // e^(s - m) = 2^(s log2 e - m log2 e): one FFMA and one SFU op each.
      const float a0 = exp2_sfu((m0 - mx0) * LOG2E);
      const float a1 = exp2_sfu((m1 - mx1) * LOG2E);
      const float ml0 = mx0 * LOG2E;
      const float ml1 = mx1 * LOG2E;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) {
          s[i] = exp2_sfu(fmaf(s[i], LOG2E, -ml1));
          rs1 += s[i];
        } else {
          s[i] = exp2_sfu(fmaf(s[i], LOG2E, -ml0));
          rs0 += s[i];
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;

      // P in bf16 as wgmma's A registers: K-step kk covers keys 16 kk ..
      // 16 kk + 15, which are accumulator elements 8 kk .. 8 kk + 7.
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P . V: V is MN-major (d contiguous); a K-step is 16 keys = 2 KB,
      // the leading byte offset steps from one 64-column box of d to the next.
#pragma unroll
      for (int i = 0; i < D / 2; ++i) pin(o[i]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<D>(o, pa[kk], sw128_desc(vs + kk * 2 * SW_ROWS8, BOX_BYTES, SW_ROWS8));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) pin(o[i]);
    }

    // Every warp is done with this stage: refill it with tile kb + STAGES.
    __syncthreads();
    if (tid == 0 && kb + STAGES < n_tiles)
      load_kv<D>(&k_map, &v_map, k_s, v_s, bar, kb + STAGES, stage, hk, bi);
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-37f);
  const float inv1 = 1.f / fmaxf(l1, 1e-37f);
  const int row0 = wq0 + r0;
  const int row1 = row0 + 8;
  const size_t row_stride = static_cast<size_t>(h) * D;
  if (row0 < sq) {
    __nv_bfloat16* dst =
        out + (static_cast<size_t>(bi) * sq + row0) * row_stride + static_cast<size_t>(hh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + c2) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
  }
  if (row1 < sq) {
    __nv_bfloat16* dst =
        out + (static_cast<size_t>(bi) * sq + row1) * row_stride + static_cast<size_t>(hh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + c2) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  // The rows' log-sum-exp for the backward: every lane of a quad holds its
  // two rows' m and l after the shuffles; the first writes them.
  if (lse != nullptr && (lane & 3) == 0) {
    float* dst = lse + (static_cast<size_t>(bi) * h + hh) * sq;
    if (row0 < sq) dst[row0] = m0 + logf(l0);
    if (row1 < sq) dst[row1] = m1 + logf(l1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so no -lcuda is needed.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (b, rows, heads, d) bf16 tensor as a 4-D map with 64 x 1 x box_rows x 1
// boxes (64 columns = 128 bytes, the 128B swizzle's limit); out-of-range
// rows read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int b,
              int rows, int heads, int d, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(heads) * d * 2,
                                 static_cast<cuuint64_t>(rows) * heads * d * 2};
  const cuuint32_t box[4] = {BOX_COLS, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int sq, int sk, int h, int kvh,
                   int causal, int q_offset, float scale,
                   cudaStream_t stream) {
  using L = Layout<D>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::smem));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(encode, &q_map, q, b, sq, h, D, L::bm) ||
      !make_map(encode, &k_map, k, b, sk, kvh, D, BN) ||
      !make_map(encode, &v_map, v, b, sk, kvh, D, BN)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>((sq + L::bm - 1) / L::bm),
                  static_cast<unsigned>(h), static_cast<unsigned>(b));
  flash_fwd_wgmma_kernel<D><<<grid, L::threads, L::smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, sq, sk, h,
      h / kvh, causal, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace tc

// --------------------------------------------------------------------------
// The backward on plain FMAs: flash_bwd_dot_kernel, flash_bwd_dkdv_kernel
// and flash_bwd_dq_kernel, f32 from shared memory, for f32 and bf16 at d =
// 16, 32, 64, 128.

namespace bwd {

constexpr int BR = 64;             // query rows or keys per tile
constexpr int SSTRIDE = BR + 1;    // f32 score tiles, padded

template <typename T, int D>
struct Layout {
  // Every operand tile is 64 rows padded to an odd number of 32-bit words,
  // so 16 lanes reading one column of 16 rows hit 16 banks, and the two
  // rows a warp's two lane groups broadcast hit two.
  static constexpr int pad = D + (sizeof(T) == 2 ? 2 : 1);
  static constexpr size_t tile =
      ((static_cast<size_t>(BR) * pad * sizeof(T)) + 15) / 16 * 16;
  static constexpr size_t stile = static_cast<size_t>(BR) * SSTRIDE * sizeof(float);
  // dK/dV: K, V, Q, dO tiles, P^T and dS^T, the query tile's lse and D.
  static constexpr size_t kv_smem = 4 * tile + 2 * stile + 2 * BR * sizeof(float);
  // dQ: Q, dO, K, V tiles and dS.
  static constexpr size_t q_smem = 4 * tile + stile;
  static constexpr int dcols = D / 16;  // output columns per thread
};

// D[b, h, i] = sum_c dO[b, i, h, c] O[b, i, h, c] in f32: one warp per
// (b, i, h) row, in memory order; D is laid out (b, h, sq) like lse.
template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ delta, int rows,
                                     int d, int sq, int h) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* op = o + static_cast<size_t>(row) * d;
  const T* gp = dout + static_cast<size_t>(row) * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f32<T>(op[c]), to_f32<T>(gp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int hh = row % h;
    const int rest = row / h;
    const int i = rest % sq;
    const int bi = rest / sq;
    delta[(static_cast<size_t>(bi) * h + hh) * sq + i] = acc;
  }
}

// 16 x 16 products of the tiles' rows a (a_row0 + 16 i) and b (b_row0 +
// 16 j) over D columns, added to acc; both tiles with row stride P.
template <typename T, int D, int P>
__device__ __forceinline__ void tile_dots(float (&acc)[4][4], const T* __restrict__ a,
                                          int a_row0, const T* __restrict__ b,
                                          int b_row0) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 2) {
      float2 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + (a_row0 + 16 * i) * P + dd));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + (b_row0 + 16 * j) * P + dd));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        }
    }
  } else {
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = to_f32<T>(a[(a_row0 + 16 * i) * P + dd]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = to_f32<T>(b[(b_row0 + 16 * j) * P + dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Grid (key tiles, KV heads, batch).  A block holds one 64-key K/V tile and
// its dK and dV in registers (thread (tx, ty): keys ty + 16 i, columns tx +
// 16 j), and walks every query tile that sees those keys, for each of the g
// query heads of the KV head: S^T = K (Q * scale)^T and dP^T = V dO^T from
// shared memory, P^T = exp(S^T - lse) and dS^T = P^T (dP^T - D) into
// shared memory, then dV += P^T dO and dK += dS^T (Q * scale).  The sum
// over the group stays in the block, in f32: no atomics.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
                      int kvh, int causal, int q_offset, float scale) {
  using L = Layout<T, D>;
  constexpr int P = L::pad;
  constexpr int DC = L::dcols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = reinterpret_cast<T*>(smem_raw + L::tile);
  T* q_s = reinterpret_cast<T*>(smem_raw + 2 * L::tile);
  T* g_s = reinterpret_cast<T*>(smem_raw + 3 * L::tile);
  float* p_s = reinterpret_cast<float*>(smem_raw + 4 * L::tile);
  float* ds_s = p_s + BR * SSTRIDE;
  float* lse_s = ds_s + BR * SSTRIDE;
  float* d_s = lse_s + BR;

  const int k0 = blockIdx.x * BR;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = h / kvh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(kvh) * D;
  const size_t kv_base = static_cast<size_t>(bi) * sk * kv_stride + static_cast<size_t>(hk) * D;

  load_tile<T, D, false>(k_s, P, k + kv_base, kv_stride, k0, sk, 0.f);
  load_tile<T, D, false>(v_s, P, v + kv_base, kv_stride, k0, sk, 0.f);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (sq + BR - 1) / BR;
  // Query row i sees key k0 iff q_offset + i >= k0: earlier tiles see none
  // of this block's keys.
  const int q_first = causal ? max(0, k0 - q_offset) / BR : 0;
  for (int hg = 0; hg < g; ++hg) {
    const int hh = hk * g + hg;
    const size_t q_base = static_cast<size_t>(bi) * sq * q_stride + static_cast<size_t>(hh) * D;
    const float* lse_row = lse + (static_cast<size_t>(bi) * h + hh) * sq;
    const float* d_row = delta + (static_cast<size_t>(bi) * h + hh) * sq;
    for (int qb = q_first; qb < nq; ++qb) {
      const int q0 = qb * BR;
      __syncthreads();  // the previous query tile is consumed
      load_tile<T, D, true>(q_s, P, q + q_base, q_stride, q0, sq, scale);
      load_tile<T, D, false>(g_s, P, dout + q_base, q_stride, q0, sq, 0.f);
      if (threadIdx.x < BR) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < sq ? lse_row[r] : 0.f;
        d_s[threadIdx.x] = r < sq ? d_row[r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_dots<T, D, P>(s, k_s, ty, q_s, tx);
      tile_dots<T, D, P>(dp, v_s, ty, g_s, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = q0 + tx + 16 * j;
          const bool valid = key < sk && qi < sq && (!causal || q_offset + qi >= key);
          const float p = valid ? expf(s[i][j] - lse_s[tx + 16 * j]) : 0.f;
          p_s[(ty + 16 * i) * SSTRIDE + tx + 16 * j] = p;
          ds_s[(ty + 16 * i) * SSTRIDE + tx + 16 * j] = p * (dp[i][j] - d_s[tx + 16 * j]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < BR; ++c) {
        float gv[DC], qv[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          gv[j] = to_f32<T>(g_s[c * P + tx + 16 * j]);
          qv[j] = to_f32<T>(q_s[c * P + tx + 16 * j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = p_s[(ty + 16 * i) * SSTRIDE + c];
          const float ds = ds_s[(ty + 16 * i) * SSTRIDE + c];
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            dv_acc[i][j] = fmaf(p, gv[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds, qv[j], dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    const size_t off = kv_base + static_cast<size_t>(key) * kv_stride;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[off + tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
      dv[off + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// Grid (query tiles, query heads, batch).  A block holds one 64-row query
// tile and its dQ in registers (thread (tx, ty): rows ty + 16 i, columns tx
// + 16 j) and walks the key tiles its rows see: S and dP from shared
// memory, dS = P (dP - D) into shared memory, dQ += dS K; dQ = scale dQ.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int sq, int sk, int h, int kvh, int causal,
                    int q_offset, float scale) {
  using L = Layout<T, D>;
  constexpr int P = L::pad;
  constexpr int DC = L::dcols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* g_s = reinterpret_cast<T*>(smem_raw + L::tile);
  T* k_s = reinterpret_cast<T*>(smem_raw + 2 * L::tile);
  T* v_s = reinterpret_cast<T*>(smem_raw + 3 * L::tile);
  float* ds_s = reinterpret_cast<float*>(smem_raw + 4 * L::tile);

  const int q0 = blockIdx.x * BR;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hh / (h / kvh);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(kvh) * D;
  const size_t q_base = static_cast<size_t>(bi) * sq * q_stride + static_cast<size_t>(hh) * D;
  const size_t kv_base = static_cast<size_t>(bi) * sk * kv_stride + static_cast<size_t>(hk) * D;

  load_tile<T, D, true>(q_s, P, q + q_base, q_stride, q0, sq, scale);
  load_tile<T, D, false>(g_s, P, dout + q_base, q_stride, q0, sq, 0.f);
  const float* lse_row = lse + (static_cast<size_t>(bi) * h + hh) * sq;
  const float* d_row = delta + (static_cast<size_t>(bi) * h + hh) * sq;
  float lse_r[4], d_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < sq ? lse_row[r] : 0.f;
    d_r[i] = r < sq ? d_row[r] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int nk = (sk + BR - 1) / BR;
  const int n_blocks = causal ? min(nk, max(0, (q_offset + q0 + BR - 1) / BR + 1)) : nk;
  for (int kb = 0; kb < n_blocks; ++kb) {
    const int k0 = kb * BR;
    __syncthreads();  // the previous key tile is consumed
    load_tile<T, D, false>(k_s, P, k + kv_base, kv_stride, k0, sk, 0.f);
    load_tile<T, D, false>(v_s, P, v + kv_base, kv_stride, k0, sk, 0.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dots<T, D, P>(s, q_s, ty, k_s, tx);
    tile_dots<T, D, P>(dp, g_s, ty, v_s, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool valid = key < sk && qi < sq && (!causal || q_offset + qi >= key);
        const float p = valid ? expf(s[i][j] - lse_r[i]) : 0.f;
        ds_s[(ty + 16 * i) * SSTRIDE + tx + 16 * j] = p * (dp[i][j] - d_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BR; ++c) {
      float kv_[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv_[j] = to_f32<T>(k_s[c * P + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = ds_s[(ty + 16 * i) * SSTRIDE + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(ds, kv_[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    T* o = dq + q_base + static_cast<size_t>(row) * q_stride;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, float* delta, int b, int sq, int sk, int h,
                   int kvh, int causal, int q_offset, float scale,
                   cudaStream_t stream) {
  using L = Layout<T, D>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kv_smem));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::q_smem));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const int rows = b * sq * h;
  flash_bwd_dot_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), gt, delta, rows, D, sq, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 kv_grid(static_cast<unsigned>((sk + BR - 1) / BR),
                     static_cast<unsigned>(kvh), static_cast<unsigned>(b));
  flash_bwd_dkdv_kernel<T, D><<<kv_grid, THREADS, L::kv_smem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      h, kvh, causal, q_offset, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 q_grid(static_cast<unsigned>((sq + BR - 1) / BR),
                    static_cast<unsigned>(h), static_cast<unsigned>(b));
  flash_bwd_dq_kernel<T, D><<<q_grid, THREADS, L::q_smem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), sq, sk, h, kvh, causal,
      q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* delta, int b, int sq,
                       int sk, int h, int kvh, int causal, int q_offset,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bwd

// --------------------------------------------------------------------------
// The backward on Hopper's tensor cores for bf16 at d = 64, 128 (the
// route on every training path): flash_bwd_prep_kernel, then
// flash_bwd_fused_wgmma_kernel and flash_bwd_dq_convert_kernel.  The
// product kernel is warp-specialised: two consumer warpgroups of 64 rows
// each (wgmma, f32 accumulators in registers, setmaxnreg 240) and a
// producer warpgroup of which one thread keeps TMA loads in flight through
// a ring of FSTAGES stages, each with a full and an empty mbarrier of its
// own.

namespace wg_bwd {

using bf16 = __nv_bfloat16;
using tc::BOX_BYTES;
using tc::BOX_COLS;
using tc::LOG2E;
using tc::SW_ROWS8;
constexpr int ROWS = 64;       // rows of a tile: one wgmma M, one TMA box
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int FSTAGES = 2;     // the ring's stages (the dS and dQ buffers take the rest)
constexpr uint32_t RELEASE = CONSUMERS * 4;  // one arrival per consumer warp

constexpr size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

template <int D>
struct Layout {
  static constexpr int boxes = D / BOX_COLS;
  static constexpr uint32_t tile = boxes * BOX_BYTES;  // 64 rows x D bf16
  // K and V of the block's 128 keys, then the ring of FSTAGES (q * scale,
  // dO) tiles and of (lse log2 e, D) vectors of 64 rows each, then two
  // dS^T buffers (128 keys x 64 queries bf16, 128B-swizzled, used in turn)
  // and the consumers' dQ partials (a 64 x 64 f32 block each, in
  // accumulator-fragment order).
  static constexpr uint32_t kv_k = 0;
  static constexpr uint32_t kv_v = kv_k + CONSUMERS * tile;
  static constexpr uint32_t ds_bytes = CONSUMERS * ROWS * ROWS * 2;
  static constexpr uint32_t dq_bytes = CONSUMERS * ROWS * ROWS * 4;
  static constexpr uint32_t f_ring = kv_v + CONSUMERS * tile;
  static constexpr uint32_t f_vec = f_ring + FSTAGES * 2 * tile;
  static constexpr uint32_t f_ds = (f_vec + FSTAGES * 2 * ROWS * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t f_dq = f_ds + 2 * ds_bytes;
  static constexpr uint32_t f_bar = f_dq + dq_bytes;
  // K/V, full[FSTAGES], empty[FSTAGES], dQ full, dQ empty.
  static constexpr uint32_t f_bars = 8 * (3 + 2 * FSTAGES);
  // Over half the SM's 227 KB, so that one block holds an SM: two blocks'
  // consumers could not both raise their registers to 240 (setmaxnreg
  // would wait forever).
  static constexpr size_t one_per_sm = 116 * 1024;
  static constexpr size_t f_smem = max_sz(f_bar + f_bars + 1024, one_per_sm);  // + alignment slack
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// A contiguous run of global memory (16-byte aligned, a multiple of 16
// bytes) into shared memory, counted in bytes on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keeps a register A operand live, unmoved, until its wgmma has completed.
__device__ __forceinline__ void pin_u(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64), both bf16 from 128B-swizzled
// shared memory and both MN-major (the two transpose bits).
__device__ __forceinline__ void wgmma_ss_m64n64_tt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// The fused kernel's ordered sum of dQ partials: a bulk copy (the first
// key tile) or a bulk f32 add (every later one) of a contiguous run of
// shared memory into global memory, in a bulk group of the calling thread.
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void add_release(uint32_t* p, uint32_t v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d / 16 K-steps of a 64 x 64 (x D) product of two K-major 128B-swizzled
// tiles (64 rows x D each): four 32-byte steps per 64-column box.
template <int D>
__device__ __forceinline__ void scores(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
    tc::wgmma_ss_m64n64(acc, tc::sw128_desc(a + off, 16, SW_ROWS8),
                        tc::sw128_desc(b + off, 16, SW_ROWS8), 1);
  }
}

// acc (64 x D) += A (64 x 64, bf16 registers: four K-steps of 16) . B (a
// 64 x D tile read MN-major: the transpose bit).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::wgmma_pv<D>(acc, a[kk], tc::sw128_desc(b + kk * 2 * SW_ROWS8, BOX_BYTES, SW_ROWS8));
}

// A 64 x 64 f32 accumulator fragment rounded to bf16 as four K-steps of
// wgmma's register A operand (K-step kk: accumulator elements 8 kk .. 8 kk + 7).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = tc::pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// For one (64-key, 64-query) tile pair: S^T = K (q scale)^T and dP^T =
// V dO^T (SS, both K-major), then P^T = exp(S^T - lse) into s (masked
// entries selected to 0) and dS^T = P^T (dP^T - D) into dp, both f32 in
// wgmma's accumulator layout.  lv holds the tile's lse log2 e, then its D.
template <int D>
__device__ __forceinline__ void tile_grads(float (&s)[32], float (&dp)[32], uint32_t ks,
                                           uint32_t vs, uint32_t qst, uint32_t dost,
                                           const float* lv, int q0, int kw0, int key0,
                                           int key1, int c2, int sq, int sk, int causal,
                                           int q_offset) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    tc::pin(s[i]);
    tc::pin(dp[i]);
  }
  tc::wg_fence();
  scores<D>(s, ks, qst);
  tc::wg_commit();
  scores<D>(dp, vs, dost);
  tc::wg_commit();
  wg_wait_one();  // S^T is in; dP^T may still run
#pragma unroll
  for (int i = 0; i < 32; ++i) tc::pin(s[i]);

  // P^T = exp(S^T - lse), masked entries selected to 0: only tiles that
  // cross the causal diagonal, sq or sk test each entry.
  const bool edge = q0 + ROWS > sq || kw0 + ROWS > sk ||
                    (causal && q_offset + q0 < kw0 + ROWS - 1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lv + 8 * j + c2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p = tc::exp2_sfu(fmaf(s[i], LOG2E, -((e & 1) ? l2.y : l2.x)));
      if (edge) {
        const int qi = q0 + 8 * j + c2 + (e & 1);
        const int key = (e & 2) ? key1 : key0;
        const bool valid = key < sk && qi < sq && (!causal || q_offset + qi >= key);
        p = valid ? p : 0.f;
      }
      s[i] = p;
    }
  }
  tc::wg_wait_all();
#pragma unroll
  for (int i = 0; i < 32; ++i) tc::pin(dp[i]);
  // dS^T = P^T (dP^T - D).
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dd = *reinterpret_cast<const float2*>(lv + ROWS + 8 * j + c2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      dp[i] = s[i] * (dp[i] - ((e & 1) ? dd.y : dd.x));
    }
  }
}

// Rows (b, i, h) of q, o and dO, one warp each, over i < sq_pad (the query
// length rounded up to 64): qs = bf16(q scale) (the forward's rounding),
// delta = rowsum(dO o O) in f32 and lse2 = lse log2 e, the last two laid
// out (b, h, sq_pad) with zeros past sq, so that a 64-row tile of either
// is one aligned 256-byte run.  It also zeroes the turn counter of each
// (b, h, 64-row tile).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout, const float* __restrict__ lse,
                      bf16* __restrict__ qs, float* __restrict__ lse2,
                      float* __restrict__ delta, uint32_t* __restrict__ turns, int rows,
                      int sq, int sq_pad, int h, float scale) {
  constexpr int E = D / 32;  // elements per lane
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;
  const int hh = w % h;
  const int rest = w / h;
  const int i = rest % sq_pad;
  const int bi = rest / sq_pad;
  float acc = 0.f;
  if (i < sq) {
    const size_t off = ((static_cast<size_t>(bi) * sq + i) * h + hh) * D + lane * E;
    __nv_bfloat162 ov[E / 2], gv[E / 2], qv[E / 2];
    if constexpr (E == 4) {
      *reinterpret_cast<uint2*>(ov) = *reinterpret_cast<const uint2*>(o + off);
      *reinterpret_cast<uint2*>(gv) = *reinterpret_cast<const uint2*>(dout + off);
      *reinterpret_cast<uint2*>(qv) = *reinterpret_cast<const uint2*>(q + off);
    } else {
      ov[0] = *reinterpret_cast<const __nv_bfloat162*>(o + off);
      gv[0] = *reinterpret_cast<const __nv_bfloat162*>(dout + off);
      qv[0] = *reinterpret_cast<const __nv_bfloat162*>(q + off);
    }
#pragma unroll
    for (int e = 0; e < E / 2; ++e) {
      const float2 of = __bfloat1622float2(ov[e]);
      const float2 gf = __bfloat1622float2(gv[e]);
      const float2 qf = __bfloat1622float2(qv[e]);
      acc = fmaf(of.x, gf.x, acc);
      acc = fmaf(of.y, gf.y, acc);
      qv[e] = __floats2bfloat162_rn(qf.x * scale, qf.y * scale);
    }
    if constexpr (E == 4) {
      *reinterpret_cast<uint2*>(qs + off) = *reinterpret_cast<uint2*>(qv);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(qs + off) = qv[0];
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const size_t r = (static_cast<size_t>(bi) * h + hh) * sq_pad + i;
    delta[r] = acc;
    lse2[r] = i < sq ? lse[(static_cast<size_t>(bi) * h + hh) * sq + i] * LOG2E : 0.f;
    if (i % ROWS == 0) turns[r / ROWS] = 0;
  }
}

// dK, dV and dQ in one kernel.  Grid (b kv, key tiles of 128): every KV
// head of key tile 0 first.  Consumer warpgroup w owns keys k0 + 64 w ..
// + 63 and their dK and dV (64 x D f32 each, in registers).  The items
// run query tile outer (the last first) and group head inner (so the sum
// over the group is taken in one fixed order); for each, S^T = K (q
// scale)^T and dP^T = V dO^T (SS, both K-major), P^T = exp(S^T - lse) and
// dS^T = P^T (dP^T - D) in registers, then dV += P^T dO and dK += dS^T (q
// scale) (RS: the bf16 accumulators as A, the tiles read MN-major as B),
// and the block's dQ partial of the tile: both consumer warpgroups put dS^T (bf16) into
// shared memory, then compute dQ_part = dS K (SS, both operands MN-major;
// at d = 128 warpgroup w takes columns 64 w .. + 63, at d = 64 all
// columns over its own keys) and store it in accumulator-fragment order.
// A reducer thread of the producer warpgroup
// adds each partial into dq_acc (b, h, query tiles, 64 x D f32 in that
// order) by bulk copy, in key-tile order: it waits until the tile's turn
// counter equals its key tile, and raises it once its add has completed.
// Key tile 0, the first contributor of every query tile, stores rather
// than adds, so dq_acc needs no zeroing.  Every block walks the query
// tiles in the same order, so key tile kt reaches a tile when kt - 1 does
// and the turns cost one add's latency, not a chain of whole blocks.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_fused_wgmma_kernel(const __grid_constant__ CUtensorMap qs_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const float* __restrict__ lse2, const float* __restrict__ delta,
                             float* __restrict__ dq_acc, uint32_t* __restrict__ turns,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                             int h, int kvh, int causal, int q_offset) {
  using L = Layout<D>;
  constexpr uint32_t DQ_BYTES = D / 64 * ROWS * ROWS * 4;  // a tile's dQ (64 x D f32)
  constexpr uint32_t DQ_FLOATS = DQ_BYTES / 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* vec = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::f_vec);
  float* dq_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::f_dq);
  // K/V at 0; full s at 8 (1 + s); empty s at 8 (1 + FSTAGES + s); dQ full,
  // dQ empty after them.
  const uint32_t bar = base + L::f_bar;
  const uint32_t dq_full = bar + 8u * (1 + 2 * FSTAGES);
  const uint32_t dq_empty = dq_full + 8u;

  const int hk = blockIdx.x % kvh;
  const int bi = blockIdx.x / kvh;
  const int kt = blockIdx.y;
  const int k0 = kt * CONSUMERS * ROWS;
  const int g = h / kvh;
  const int nq = (sq + ROWS - 1) / ROWS;
  const int sq_pad = nq * ROWS;
  const int q_first = causal ? min(nq, max(0, k0 - q_offset) / ROWS) : 0;
  const int n_it = g * (nq - q_first);

  if (threadIdx.x == 0) {
    tc::mbar_init(bar, 1);
#pragma unroll
    for (int s = 0; s < FSTAGES; ++s) {
      tc::mbar_init(bar + 8u * (1 + s), 1);
      tc::mbar_init(bar + 8u * (1 + FSTAGES + s), RELEASE);
    }
    tc::mbar_init(dq_full, CONSUMERS * 4);
    tc::mbar_init(dq_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {  // the producer warpgroup
    regs_dealloc<24>();
    if (n_it == 0) return;
    if (threadIdx.x == CONSUMERS * 128) {  // TMA loads
      tc::mbar_expect_tx(bar, 2 * CONSUMERS * L::tile);
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w)
#pragma unroll
        for (int x = 0; x < L::boxes; ++x) {
          const uint32_t off = w * L::tile + x * BOX_BYTES;
          tc::tma_load_4d(base + L::kv_k + off, &k_map, bar, x * BOX_COLS, hk, k0 + w * ROWS, bi);
          tc::tma_load_4d(base + L::kv_v + off, &v_map, bar, x * BOX_COLS, hk, k0 + w * ROWS, bi);
        }
      int stage = 0, phase = 0;
      for (int it = 0; it < n_it; ++it) {
        if (it >= FSTAGES) tc::mbar_wait(bar + 8u * (1 + FSTAGES + stage), phase ^ 1);
        const int hh = hk * g + it % g;
        const int q0 = (nq - 1 - it / g) * ROWS;
        const uint32_t full = bar + 8u * (1 + stage);
        const uint32_t ring = base + L::f_ring + stage * 2 * L::tile;
        tc::mbar_expect_tx(full, 2 * L::tile + 2 * ROWS * 4);
#pragma unroll
        for (int x = 0; x < L::boxes; ++x) {
          tc::tma_load_4d(ring + x * BOX_BYTES, &qs_map, full, x * BOX_COLS, hh, q0, bi);
          tc::tma_load_4d(ring + L::tile + x * BOX_BYTES, &do_map, full, x * BOX_COLS, hh, q0, bi);
        }
        const size_t r = (static_cast<size_t>(bi) * h + hh) * sq_pad + q0;
        const uint32_t v_s = base + L::f_vec + stage * 2 * ROWS * 4;
        bulk_load(v_s, lse2 + r, ROWS * 4, full);
        bulk_load(v_s + ROWS * 4, delta + r, ROWS * 4, full);
        if (++stage == FSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (threadIdx.x == CONSUMERS * 128 + 32) {  // the ordered dQ adds
      for (int it = 0; it < n_it; ++it) {
        tc::mbar_wait(dq_full, it & 1);
        const size_t t = (static_cast<size_t>(bi) * h + hk * g + it % g) * nq + (nq - 1 - it / g);
        float* dst = dq_acc + t * DQ_FLOATS;
        if (kt == 0) {
          bulk_store(dst, base + L::f_dq, DQ_BYTES);
        } else {
          while (load_acquire(turns + t) != static_cast<uint32_t>(kt)) __nanosleep(64);
          fence_async_global();
          bulk_add(dst, base + L::f_dq, DQ_BYTES);
        }
        if constexpr (D == 64) {  // the second warpgroup's keys' partial
          bulk_commit();
          bulk_wait();
          bulk_add(dst, base + L::f_dq + DQ_BYTES, DQ_BYTES);
        }
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(dq_empty);  // the buffer may be refilled
        bulk_wait();
        fence_async_global();
        add_release(turns + t, 1);
      }
    }
    return;
  }

  regs_alloc<240>();
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  const int kw0 = k0 + wg * ROWS;
  const int key0 = kw0 + r0;
  const int key1 = key0 + 8;
  const uint32_t ks = base + L::kv_k + wg * L::tile;
  const uint32_t vs = base + L::kv_v + wg * L::tile;
  // This warpgroup's dQ product: at d = 128 columns 64 wg .. + 63 over
  // all 128 keys (8 K-steps, B = box wg of the K tiles); at d = 64 all 64
  // columns over its own 64 keys (4 K-steps), the two partials added in
  // turn.  The same instructions on every warpgroup: a branch around a
  // wgmma would make ptxas serialise them.
  constexpr int DQ_STEPS = D == 128 ? 8 : 4;
  const int dq_k0 = D == 128 ? 0 : 4 * wg;
  const uint32_t dq_b = base + L::kv_k + (D == 128 ? wg * BOX_BYTES : 0);

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  if (n_it > 0) tc::mbar_wait(bar, 0);
  int stage = 0, phase = 0;
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (nq - 1 - it / g) * ROWS;
    tc::mbar_wait(bar + 8u * (1 + stage), phase);
    // Every item runs every product, also where no row of the tile sees a
    // warpgroup's keys (past sk, or on the diagonal's far side): those
    // tiles cross an edge, so every entry is selected to 0.
    const uint32_t qst = base + L::f_ring + stage * 2 * L::tile;
    const uint32_t dost = qst + L::tile;
    const uint32_t ds = base + L::f_ds + (it & 1) * L::ds_bytes;
    const float* lv = vec + stage * 2 * ROWS;
    float s[32], dp[32];
    tile_grads<D>(s, dp, ks, vs, qst, dost, lv, q0, kw0, key0, key1, c2, sq, sk, causal,
                  q_offset);
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, s);
    pack_a(da, dp);
    // dS^T into rows 64 wg + r0 (+ 8) of the swizzled buffer: the word of
    // columns 8 c + c2, c2 + 1 goes to 16-byte chunk c ^ (row & 7).
    const uint32_t row = ds + (wg * ROWS + r0) * 128 + (lane & 3) * 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t chunk = (2 * kk + (e >> 1)) ^ (lane >> 2);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(row + (e & 1) * 8 * 128 + chunk * 16),
                     "r"(da[kk][e])
                     : "memory");
      }
    fence_async_shared();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both halves of dS^T are in

    float dqa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) tc::pin(dqa[i]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      tc::pin(dva[i]);
      tc::pin(dka[i]);
    }
    tc::wg_fence();
    accumulate<D>(dva, pa, dost);
    accumulate<D>(dka, da, qst);
#pragma unroll
    for (int kk = 0; kk < DQ_STEPS; ++kk) {
      const int k = dq_k0 + kk;  // K-step of 16 keys: A is dS^T's buffer
      wgmma_ss_m64n64_tt(dqa, tc::sw128_desc(ds + k * 2 * SW_ROWS8, BOX_BYTES, SW_ROWS8),
                         tc::sw128_desc(dq_b + (k >> 2) * L::tile + (k & 3) * 2 * SW_ROWS8,
                                        BOX_BYTES, SW_ROWS8));
    }
    tc::wg_commit();
    tc::wg_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) tc::pin(dqa[i]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      tc::pin(dva[i]);
      tc::pin(dka[i]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pin_u(pa[kk][e]);
        pin_u(da[kk][e]);
      }
    if (it > 0) tc::mbar_wait(dq_empty, (it - 1) & 1);
    float4* dst = reinterpret_cast<float4*>(dq_s) + wg * 8 * 128 + tid;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j * 128] = make_float4(dqa[4 * j], dqa[4 * j + 1], dqa[4 * j + 2], dqa[4 * j + 3]);
    fence_async_shared();
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(dq_full);
      mbar_arrive(bar + 8u * (1 + FSTAGES + stage));
    }
    if (++stage == FSTAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const size_t row_stride = static_cast<size_t>(kvh) * D;
  const size_t head = static_cast<size_t>(bi) * sk * row_stride + static_cast<size_t>(hk) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key1 : key0;
    if (key >= sk) continue;
    bf16* kd = dk + head + static_cast<size_t>(key) * row_stride;
    bf16* vd = dv + head + static_cast<size_t>(key) * row_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(kd + 8 * j + c2) =
          __floats2bfloat162_rn(dka[4 * j + 2 * half], dka[4 * j + 2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vd + 8 * j + c2) =
          __floats2bfloat162_rn(dva[4 * j + 2 * half], dva[4 * j + 2 * half + 1]);
    }
  }
}

// dq = bf16(scale dq_acc): a block of 128 threads per (b, h, 64-row tile).
// Thread t reads the fragment words thread t of each warpgroup stored
// (coalesced float4 runs) and puts them in shared memory by row; then
// each row of dq (D bf16, contiguous) is written in 16-byte pieces.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_convert_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq, int sq,
                            int h, int nq, float scale) {
  constexpr int PITCH = D + 4;  // f32 per row in shared memory, padded
  __shared__ float tile[ROWS * PITCH];
  const int t = blockIdx.x;
  const int qt = t % nq;
  const int hh = (t / nq) % h;
  const int bi = t / nq / h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  const float4* src = reinterpret_cast<const float4*>(dq_acc) +
                      static_cast<size_t>(t) * (D / 64) * 8 * 128 + tid;
#pragma unroll
  for (int w = 0; w < D / 64; ++w)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 x = src[(w * 8 + j) * 128];
      const int col = 64 * w + 8 * j + c2;
      *reinterpret_cast<float2*>(tile + r0 * PITCH + col) = make_float2(x.x, x.y);
      *reinterpret_cast<float2*>(tile + (r0 + 8) * PITCH + col) = make_float2(x.z, x.w);
    }
  __syncthreads();
  constexpr int PIECES = D / 8;  // 16-byte pieces per row
  const size_t row_stride = static_cast<size_t>(h) * D;
  bf16* out = dq + (static_cast<size_t>(bi) * sq + qt * ROWS) * row_stride +
              static_cast<size_t>(hh) * D;
  for (int i = tid; i < ROWS * PIECES; i += 128) {
    const int r = i / PIECES;
    const int c = (i % PIECES) * 8;
    if (qt * ROWS + r >= sq) break;  // rows go up with i
    const float* x = tile + r * PITCH + c;
    uint4 v;
    v.x = tc::pack_bf16(x[0] * scale, x[1] * scale);
    v.y = tc::pack_bf16(x[2] * scale, x[3] * scale);
    v.z = tc::pack_bf16(x[4] * scale, x[5] * scale);
    v.w = tc::pack_bf16(x[6] * scale, x[7] * scale);
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * row_stride + c) = v;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, void* dq, void* dk, void* dv,
                   void* qs, float* lse2, float* delta, float* dq_acc, uint32_t* turns, int b,
                   int sq, int sk, int h, int kvh, int causal, int q_offset, float scale,
                   cudaStream_t stream) {
  using L = Layout<D>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(flash_bwd_fused_wgmma_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(L::f_smem));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int nq = (sq + ROWS - 1) / ROWS;
  const int sq_pad = nq * ROWS;
  const int rows = b * sq_pad * h;
  flash_bwd_prep_kernel<D><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      lse, static_cast<bf16*>(qs), lse2, delta, turns, rows, sq, sq_pad, h, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap qs_map, do_map, k_map, v_map;
  if (!tc::make_map(encode, &qs_map, qs, b, sq, h, D, ROWS) ||
      !tc::make_map(encode, &do_map, dout, b, sq, h, D, ROWS) ||
      !tc::make_map(encode, &k_map, k, b, sk, kvh, D, ROWS) ||
      !tc::make_map(encode, &v_map, v, b, sk, kvh, D, ROWS)) {
    return cudaErrorInvalidValue;
  }
  const int span = CONSUMERS * ROWS;
  const dim3 kv_grid(static_cast<unsigned>(b * kvh), static_cast<unsigned>((sk + span - 1) / span));
  flash_bwd_fused_wgmma_kernel<D><<<kv_grid, THREADS, L::f_smem, stream>>>(
      qs_map, do_map, k_map, v_map, lse2, delta, dq_acc, turns, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, sk, h, kvh, causal, q_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_convert_kernel<D><<<b * h * nq, 128, 0, stream>>>(
      dq_acc, static_cast<bf16*>(dq), sq, h, nq, scale);
  return cudaGetLastError();
}

}  // namespace wg_bwd

}  // namespace


// q: (b, sq, h, d); k, v: (b, sk, kv, d); out: (b, sq, h, d); contiguous,
// 16-byte aligned, h a multiple of kv.  dtype: 0 = float32, 1 = bfloat16.
// lse: (b, h, sq) f32 or null; when given, each row's log-sum-exp of its
// scaled scores is written there (the backward's input).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int dtype, int b, int sq, int sk, int h,
                                      int kvh, int d, int causal, int q_offset,
                                      float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || h < kvh || h % kvh != 0 ||
      h > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_d<float>(d, q, k, v, out, static_cast<float*>(lse), b, sq, sk, h, kvh, causal, q_offset, scale, stream);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, out, static_cast<float*>(lse), b, sq, sk, h, kvh, causal, q_offset, scale, stream);
  }
  return static_cast<int>(err);
}

// bf16 q: (b, sq, h, d); k, v: (b, sk, kv, d); out: (b, sq, h, d);
// contiguous, 16-byte aligned, d 64 or 128, h a multiple of kv.  The
// tensor-core kernel; flash_attention_launch takes everything else.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, void* lse,
                                            int b, int sq, int sk, int h,
                                            int kvh, int d, int causal,
                                            int q_offset, float scale,
                                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || h < kvh || h % kvh != 0 ||
      h > 65535 || b > 65535 || q_offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64) {
    err = tc::launch<64>(q, k, v, out, static_cast<float*>(lse), b, sq, sk, h, kvh, causal, q_offset, scale, stream);
  } else if (d == 128) {
    err = tc::launch<128>(q, k, v, out, static_cast<float*>(lse), b, sq, sk, h, kvh, causal, q_offset, scale, stream);
  }
  return static_cast<int>(err);
}

// The backward of the forward above: q, o, dout, dq: (b, sq, h, d); k, v,
// dk, dv: (b, sk, kv, d); lse and delta (scratch, written here): (b, h, sq)
// f32; contiguous, 16-byte aligned, h a multiple of kv, d in 16, 32, 64,
// 128.  dtype: 0 = float32, 1 = bfloat16.  Three launches on the stream:
// D = rowsum(dO o O), then dK/dV, then dQ.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int dtype, int b, int sq, int sk, int h, int kvh, int d,
    int causal, int q_offset, float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || h < kvh || h % kvh != 0 ||
      h > 65535 || b > 65535 || q_offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = bwd::dispatch_d<float>(d, q, k, v, o, l, dout, dq, dk, dv, dl, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
  } else if (dtype == 1) {
    err = bwd::dispatch_d<__nv_bfloat16>(d, q, k, v, o, l, dout, dq, dk, dv, dl, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
  }
  return static_cast<int>(err);
}

// The backward's Hopper kernels: bf16 only, d 64 or 128.  As
// flash_attention_bwd_launch, plus the scratch the kernels write and read:
// qs (b, sq, h, d) bf16 (q * scale), and lse2 and delta, each (b, h,
// sq_pad) f32, where sq_pad is sq rounded up to the kernels' 64-row tile
// (the call is refused if it is not), dq_acc (b, h, sq_pad, d) f32 and
// turns (b, h, sq_pad / 64) u32.  Three launches: prep, the fused kernel,
// the dQ conversion.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* qs, void* lse2, void* delta, void* dq_acc, void* turns, int sq_pad,
    int b, int sq, int sk, int h, int kvh, int d, int causal, int q_offset,
    float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || h < kvh || h % kvh != 0 ||
      h > 65535 || b > 65535 || q_offset < 0 ||
      sq_pad != (sq + wg_bwd::ROWS - 1) / wg_bwd::ROWS * wg_bwd::ROWS ||
      dq_acc == nullptr || turns == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* l = static_cast<const float*>(lse);
  float* l2 = static_cast<float*>(lse2);
  float* dl = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  uint32_t* t = static_cast<uint32_t*>(turns);
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64) {
    err = wg_bwd::launch<64>(q, k, v, o, l, dout, dq, dk, dv, qs, l2, dl, acc, t, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
  } else if (d == 128) {
    err = wg_bwd::launch<128>(q, k, v, o, l, dout, dq, dk, dv, qs, l2, dl, acc, t, b, sq, sk, h, kvh, causal, q_offset, scale, stream);
  }
  return static_cast<int>(err);
}
