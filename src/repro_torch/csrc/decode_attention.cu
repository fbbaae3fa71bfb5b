// decode_attention: one query token per sequence against a ragged KV cache,
// for Hopper (flash-decoding in one launch).
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
// v's dtype before P.V (l sums them unrounded), masked scores are NEG_INF =
// -0.7 * FLT_MAX, and the result is acc / max(l, 1e-37) in the input dtype.
// A row with lengths[b] == 0 gets exact zeros.
//
// Bound: HBM bytes.  Each cache row is read once and used for g query heads,
// so a step does ~4g flops per byte of K/V, far under the card's ~295 bf16
// operations per byte.  So the design reads only rows < lengths[b], each
// exactly once, keeps many loads in flight on every SM, keeps each warp's
// instructions per row few, and pays one launch per call:
//
//   * One launch.  Grid (splits, kv heads, batch); `splits` comes from the
//     shapes alone (kernels/decode_attention/ops.py::plan: no host sync).
//     Each block derives its row range from lengths[b] on the device
//     (ops.py::split_range mirrors it): rows = ceil(len / splits) rounded up
//     to whole 16-row groups, split i takes [i * rows, min((i + 1) * rows,
//     len)).  Every split of a sequence gets an equal share, and the blocks
//     past the last non-empty split (eff = ceil(len / rows) of them are
//     non-empty) exit at once: an empty arena slot costs no reads.  A fixed
//     `block_k` replaces rows (ops.py keeps its old meaning: rows per split).
//   * The combine in the same launch.  With eff == 1 the block normalises
//     and writes the output.  Otherwise each block writes its unnormalised
//     (acc, m, l) partial, and the block that draws the last ticket of its
//     (sequence, KV head) folds the eff partials in split order (as
//     combine_partials does, ref.py, with a running max), staged through
//     its free ring in one round trip, and resets the ticket to 0: an int
//     ticket per (sequence, KV head), drawn with atom.add.acq_rel.gpu after
//     a block barrier (the pattern of fed_reduce.cu), partials read back
//     with __ldcg.  No float atomics: the same input gives the same bits on
//     every launch.
//   * A ring of K/V tiles per warp.  Each of the 4 warps walks every fourth
//     tile of the block's range through its own ring in shared memory,
//     filled by 16-byte cp.async (L2 only) ahead of the tile it computes.
//     A warp synchronises only with itself (cp.async.wait_group and
//     __syncwarp); the block meets once, at the end.  Rows past the range
//     are never read: their copies zero-fill and their scores are selected
//     to NEG_INF.
//   * bf16 at d = 64 and 128 (every model's width) runs the tile on the
//     tensor cores (mma_stream: mma.sync m16n8k16 with the g heads as the
//     rows, ldmatrix from an XOR-swizzled 3-stage ring of 16-row tiles, the
//     online softmax on the accumulator fragments with ex2.approx, P kept
//     in registers as the next product's A operand).  On the card the
//     plain-FMA stream's dependent FMAs, shuffles and unpacks per tile,
//     with one warp per scheduler, not the bytes, set its pace.
//   * f32 (TF32 would break its 3e-5 tolerance) and bf16 at other widths
//     run the plain-FMA stream: a row is read by D / 8 (bf16) or D / 4
//     (f32) lanes, each holding one 16-byte chunk of q (all g heads) in
//     registers; a score is a 16-byte shared load, 8 FMAs per head and a
//     butterfly of shuffles over the row's lanes (every lane ends with the
//     same bits); each warp keeps its own online softmax, one max per
//     4-step tile, and every lane folds p * v into the acc of its chunk.
//   * At the end the row groups or quads, then the warps (in order), then
//     the splits fold.
//   * K2p (decode_attention_partial_launch) is the same launch with the
//     fold's state as its output: the unnormalised acc and each head's
//     (m, l), in f32, for a combine across ranks that each hold one block
//     of the cache's sequence (distribution/steps.py).  An empty block
//     gives acc = 0, m = NEG_INF, l = 0 exactly.
//
// Plain C interface, loaded through ctypes; the launch goes on the caller's
// stream and the function returns its cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP = 16;
constexpr int ROW_GROUP = 16;  // a by-length split is whole 16-row groups
constexpr int STAGES = 3;      // per-warp ring depth
constexpr int NS = 4;          // steps per warp tile
constexpr int MAX_CLUSTER = 8;  // splits folded through distributed shared memory

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

// The VEC elements of a 16-byte chunk as f32.
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[VEC]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 t = __bfloat1622float2(e[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared through L2 only; src_bytes = 0 reads
// nothing and fills zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The split's ticket: atomicAdd with release and acquire semantics at
// device scope (fed_reduce.cu's draw_ticket).
__device__ __forceinline__ int draw_ticket(int* ticket) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

template <typename T, int D>
struct Geo {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements per chunk
  static constexpr int CPR = D / VEC;                          // chunks per row
  static constexpr int LPR = CPR < 32 ? CPR : 32;              // lanes per row
  static constexpr int CPL = CPR / LPR;                        // chunks per lane
  static constexpr int RPS = 32 / LPR;                         // rows per step
  static constexpr int WR = NS * RPS;                          // rows per warp tile
  static constexpr int TILE = WR * D;                          // elements of K (or V)
  static constexpr int WARP_RING = STAGES * 2 * TILE;          // elements per warp
  static constexpr int CHUNKS = WR * CPR / 32;                 // K chunks per lane per tile
};

template <int D>
struct MmaGeo;

template <typename T, int D, bool MMA>
__host__ __device__ constexpr size_t ring_bytes() {
  if constexpr (MMA) {
    return static_cast<size_t>(WARPS) * MmaGeo<D>::WARP_RING * sizeof(T);
  } else {
    return static_cast<size_t>(WARPS) * Geo<T, D>::WARP_RING * sizeof(T);
  }
}

// Ring, then per warp (m, l) for g heads and acc (g x D), then the block's
// folded partial (acc, then (m, l) per head), in f32.
template <typename T, int D, bool MMA>
size_t smem_bytes(int g) {
  return ring_bytes<T, D, MMA>() + static_cast<size_t>(WARPS + 1) * g * (D + 2) * sizeof(float);
}

// Rows [lo, hi) of split `split` of a sequence of `len` rows (len > 0), and
// the number of non-empty splits: ops.py::split_range mirrors it.
__device__ __forceinline__ void split_rows(int len, int split, int splits, int fixed_rows,
                                           int& lo, int& hi, int& eff) {
  int rows = fixed_rows;
  if (rows == 0) {
    rows = (len + splits - 1) / splits;
    rows = (rows + ROW_GROUP - 1) / ROW_GROUP * ROW_GROUP;
  }
  eff = (len + rows - 1) / rows;
  lo = split * rows;
  hi = min(lo + rows, len);
}

// The bf16 path at d = 64, 128: mma.sync m16n8k16 with the g query heads
// as the 16 rows of A (zero past g).  The tensor cores waste 16 - g of
// every 16 rows, but a 16-row tile of the cache then costs a warp ~80
// instructions (ldmatrix, 2 x d / 16 products, a softmax on fragments)
// instead of ~1100 FMAs, shuffles and unpacks (counted from the code): the
// plain-FMA stream left a single warp per scheduler waiting on its own
// dependencies.
template <int D>
struct MmaGeo {
  static constexpr int TR = 16;                   // cache rows per warp tile
  static constexpr int TILE = TR * D;             // elements of K (or V)
  static constexpr int STG = STAGES;              // ring depth
  static constexpr int WARP_RING = STG * 2 * TILE;
  static constexpr int CHUNKS = TR * (D / 8) / 32;  // 16-byte K chunks per lane per tile
};

// Element offset of (row r, 16-byte chunk c) in a tile of D-wide bf16 rows,
// the chunk XOR-swizzled by r mod 8 so the 8 rows an ldmatrix reads hit 8
// distinct bank groups.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d (16 x 8, f32) += a (16 x 16, bf16, rows) . b (16 x 8, bf16, columns).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}
// 2^x on the SFU (ex2.approx: ~2 ulp; 0 for x = -inf).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;

// One warp's share of the block's rows [lo, hi) on the tensor cores:
// 16-row tiles warp, warp + WARPS, ... through a 3-stage cp.async ring.
// Fragment rows are heads gq and gq + 8 (gq = lane / 4); a thread holds
// keys / columns 2 t4, 2 t4 + 1 (t4 = lane % 4) of each 8-wide block.
// Publishes the warp's (m, l) and acc for heads < g into wml / wacc.
template <int D>
__device__ __forceinline__ void mma_stream(const __nv_bfloat16* __restrict__ q,
                                           const __nv_bfloat16* __restrict__ k,
                                           const __nv_bfloat16* __restrict__ v, size_t head0,
                                           size_t base, size_t row_stride, int lo, int hi, int g,
                                           float scale, __nv_bfloat16* ring, float* wml,
                                           float* wacc, int warp, int lane) {
  using MG = MmaGeo<D>;
  constexpr int KK = D / 16;  // k-steps of Q.K^T
  constexpr int NJ = D / 8;   // 8-column blocks of P.V
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  const int gq = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  ring += warp * MG::WARP_RING;
  const int n_tiles = (hi - lo + MG::TR - 1) / MG::TR;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + WARPS - 1) / WARPS : 0;

  auto issue = [&](int i, int st) {
    const int r0 = lo + (warp + WARPS * i) * MG::TR;
    __nv_bfloat16* ks = ring + st * 2 * MG::TILE;
    __nv_bfloat16* vs = ks + MG::TILE;
#pragma unroll
    for (int j = 0; j < MG::CHUNKS; ++j) {
      const int c = lane + 32 * j;
      const int r = c / CPR;
      const int cc = c - r * CPR;
      const bool ok = r0 + r < hi;
      const size_t off = base + static_cast<size_t>(ok ? r0 + r : lo) * row_stride + cc * 8;
      cp_async16(smem_u32(ks + swz<D>(r, cc)), k + off, ok ? 16 : 0);
      cp_async16(smem_u32(vs + swz<D>(r, cc)), v + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < MG::STG - 1; ++i) {
    if (i < my_tiles) issue(i, i);
    cp_async_commit();
  }

  // q * scale rounded to bf16, as A fragments (rows gq, gq + 8; zero past
  // g), loaded while the first tiles fly.
  uint32_t qa[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = gq + 8 * (e & 1);
      const int col = 16 * kk + 8 * (e >> 1) + 2 * t4;
      float2 f = make_float2(0.f, 0.f);
      if (row < g)
        f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(q + (head0 + row) * D + col));
      qa[kk][e] = pack_bf16(f.x * scale, f.y * scale);
    }
  }

  float o[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // heads gq, gq + 8

  for (int i = 0; i < my_tiles; ++i) {
    const int nxt = i + MG::STG - 1;
    if (nxt < my_tiles) issue(nxt, nxt % MG::STG);
    cp_async_commit();
    cp_async_wait<MG::STG - 1>();
    __syncwarp();
    const __nv_bfloat16* ks = ring + (i % MG::STG) * 2 * MG::TILE;
    const __nv_bfloat16* vs = ks + MG::TILE;
    const int r0 = lo + (warp + WARPS * i) * MG::TR;

    // S = Q.K^T for keys r0 .. r0 + 15: ldmatrix gives the B fragments of
    // both 8-key blocks for one k-step.
    // Two chains of products (even and odd k-steps) halve the wait on the
    // accumulator.
    float s[2][4], s2[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = s2[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; kk += 2) {
      uint32_t b[4], c[4];
      ldsm_x4(smem_u32(ks + swz<D>(8 * (mi >> 1) + (lane & 7), 2 * kk + (mi & 1))), b);
      ldsm_x4(smem_u32(ks + swz<D>(8 * (mi >> 1) + (lane & 7), 2 * kk + 2 + (mi & 1))), c);
      mma_bf16(s[0], qa[kk], b[0], b[1]);
      mma_bf16(s[1], qa[kk], b[2], b[3]);
      mma_bf16(s2[0], qa[kk + 1], c[0], c[1]);
      mma_bf16(s2[1], qa[kk + 1], c[2], c[3]);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] += s2[nb][e];
    if (r0 + MG::TR > hi) {  // keys past the range: selected to NEG_INF
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (r0 + 8 * nb + 2 * t4 + (e & 1) >= hi) s[nb][e] = NEG_INF;
    }

    // Online softmax per head row; the row's 16 keys lie in a quad.
    float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    mx0 = fmaxf(m0, mx0);
    mx1 = fmaxf(m1, mx1);
    const float a0 = exp2_sfu((m0 - mx0) * LOG2E);
    const float a1 = exp2_sfu((m1 - mx1) * LOG2E);
    const float ml0 = mx0 * LOG2E, ml1 = mx1 * LOG2E;
    float p[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nb][e] = exp2_sfu(fmaf(s[nb][e], LOG2E, (e & 2) ? -ml1 : -ml0));
    l0 = l0 * a0 + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
    l1 = l1 * a1 + (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // P in bf16 as A fragments (the accumulator layout of both key blocks
    // is A's), then O += P.V with ldmatrix.trans giving V's B fragments.
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int j2 = 0; j2 < NJ / 2; ++j2) {
      uint32_t b[4];
      ldsm_x4_t(smem_u32(vs + swz<D>(8 * (mi & 1) + (lane & 7), 2 * j2 + (mi >> 1))), b);
      mma_bf16(o[2 * j2], pa, b[0], b[1]);
      mma_bf16(o[2 * j2 + 1], pa, b[2], b[3]);
    }
    __syncwarp();  // every lane is done with this stage before it refills
  }
  cp_async_wait<0>();

  // l sums over the quad (m is the same in all four lanes).
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (t4 == 0) {
    if (gq < g) {
      wml[(warp * g + gq) * 2] = m0;
      wml[(warp * g + gq) * 2 + 1] = l0;
    }
    if (gq + 8 < g) {
      wml[(warp * g + gq + 8) * 2] = m1;
      wml[(warp * g + gq + 8) * 2 + 1] = l1;
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * j + 2 * t4;
    if (gq < g) {
      wacc[(warp * g + gq) * D + col] = o[j][0];
      wacc[(warp * g + gq) * D + col + 1] = o[j][1];
    }
    if (gq + 8 < g) {
      wacc[(warp * g + gq + 8) * D + col] = o[j][2];
      wacc[(warp * g + gq + 8) * D + col + 1] = o[j][3];
    }
  }
}

// Grid (splits, kv heads, batch).  Block: one split of one (sequence, KV
// head), all g query heads of the group (g <= G); MMA: the bf16 tensor-core
// stream, else the plain-FMA one.
template <typename T, int D, int G, bool MMA>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, void* __restrict__ out_raw,
              float* __restrict__ out_m, float* __restrict__ out_l, float* part_o,
              float* part_ml, int* tickets, int s_len, int kvh, int g, int splits,
              int fixed_rows, int cluster, int partial, float scale) {
  using GE = Geo<T, D>;
  constexpr int VEC = GE::VEC, CPR = GE::CPR, LPR = GE::LPR, CPL = GE::CPL;
  constexpr int RPS = GE::RPS, WR = GE::WR;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t head0 = (static_cast<size_t>(bi) * kvh + hk) * g;

  // Output i (head i / D, column i % D) of the folded state (acc, m, l):
  // acc / max(l, 1e-37) in T, or (K2p, `partial`) the unnormalised acc and
  // each head's (m, l) in f32.
  auto emit = [&](int i, float acc, float m, float l) {
    if (partial) {
      static_cast<float*>(out_raw)[head0 * D + i] = acc;
      if (i % D == 0) {
        out_m[head0 + i / D] = m;
        out_l[head0 + i / D] = l;
      }
    } else {
      static_cast<T*>(out_raw)[head0 * D + i] = from_f32<T>(acc / fmaxf(l, 1e-37f));
    }
  };

  const int len = min(max(lengths[bi], 0), s_len);
  if (len == 0 && !cluster) {  // exact zeros (K2p: m = NEG_INF, l = 0), written once
    if (split == 0)
      for (int i = tid; i < g * D; i += THREADS) emit(i, 0.f, NEG_INF, 0.f);
    return;
  }
  int lo = 0, hi = 0, eff = 0;
  if (len > 0) split_rows(len, split, splits, fixed_rows, lo, hi, eff);
  // Past the last non-empty split: no reads (and, with tickets, nothing
  // more: a cluster's blocks all meet at its barriers).
  const bool active = split < eff;
  if (!cluster && !active) return;

  const size_t row_stride = static_cast<size_t>(kvh) * D;
  const size_t base = static_cast<size_t>(bi) * s_len * row_stride + static_cast<size_t>(hk) * D;
  float* wml = reinterpret_cast<float*>(smem_raw + ring_bytes<T, D, MMA>());  // [WARPS][g][2]
  float* wacc = wml + WARPS * g * 2;  // [WARPS][g][D]
  if constexpr (MMA) {
    if (active)
      mma_stream<D>(q, k, v, head0, base, row_stride, lo, hi, g, scale,
                    reinterpret_cast<__nv_bfloat16*>(smem_raw), wml, wacc, warp, lane);
  } else if (active) {
    // This lane's place in a step: row group grp (row grp of each step) and
    // chunk columns cl + LPR * c of that row.
    const int grp = lane / LPR;
    const int cl = lane % LPR;

    T* ring = reinterpret_cast<T*>(smem_raw) + warp * GE::WARP_RING;
    const int n_tiles = (hi - lo + WR - 1) / WR;
    const int my_tiles = warp < n_tiles ? (n_tiles - warp + WARPS - 1) / WARPS : 0;

    // Tile i of this warp (block tile warp + WARPS * i) into stage st.
    auto issue = [&](int i, int st) {
      const int r0 = lo + (warp + WARPS * i) * WR;
      T* ks = ring + st * 2 * GE::TILE;
      T* vs = ks + GE::TILE;
#pragma unroll
      for (int j = 0; j < GE::CHUNKS; ++j) {
        const int c = lane + 32 * j;
        const int r = c / CPR;
        const int cc = c - r * CPR;
        const bool ok = r0 + r < hi;
        const size_t off = base + static_cast<size_t>(ok ? r0 + r : lo) * row_stride + cc * VEC;
        cp_async16(smem_u32(ks + r * D + cc * VEC), k + off, ok ? 16 : 0);
        cp_async16(smem_u32(vs + r * D + cc * VEC), v + off, ok ? 16 : 0);
      }
    };

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < my_tiles) issue(i, i);
      cp_async_commit();
    }
    // q * scale rounded to T, for this lane's chunks, all heads (loaded
    // while the first tiles fly).
    float qr[G][CPL][VEC];
#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float f[VEC];
        if (h < g) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
              q + (head0 + h) * D + (cl + LPR * c) * VEC));
          unpack<T, VEC>(raw, f);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) f[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[h][c][e] = round_to<T>(f[e] * scale);
      }
    }

    float m[G], l[G], acc[G][CPL][VEC];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      m[h] = NEG_INF;
      l[h] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][c][e] = 0.f;
    }

    for (int i = 0; i < my_tiles; ++i) {
      const int nxt = i + STAGES - 1;
      if (nxt < my_tiles) issue(nxt, nxt % STAGES);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();  // this lane's copies of tile i have landed
      __syncwarp();                 // and every lane's
      const T* ks = ring + (i % STAGES) * 2 * GE::TILE;
      const T* vs = ks + GE::TILE;
      const int r0 = lo + (warp + WARPS * i) * WR;

      // Scores of this lane's row in each step.
      float s[G][NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int r = j * RPS + grp;
        float part[G];
#pragma unroll
        for (int h = 0; h < G; ++h) part[h] = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float kf[VEC];
          unpack<T, VEC>(*reinterpret_cast<const uint4*>(ks + r * D + (cl + LPR * c) * VEC), kf);
#pragma unroll
          for (int h = 0; h < G; ++h)
#pragma unroll
            for (int e = 0; e < VEC; ++e) part[h] = fmaf(qr[h][c][e], kf[e], part[h]);
        }
#pragma unroll
        for (int h = 0; h < G; ++h) {
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) part[h] += __shfl_xor_sync(0xffffffffu, part[h], o);
          s[h][j] = r0 + r < hi ? part[h] : NEG_INF;
        }
      }

      // Online softmax over the tile: one max per head for the warp.
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float mt = s[h][0];
#pragma unroll
        for (int j = 1; j < NS; ++j) mt = fmaxf(mt, s[h][j]);
#pragma unroll
        for (int o = 16; o >= LPR; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[h], mt);
        const float alpha = expf(m[h] - m_new);
        m[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p = r0 + j * RPS + grp < hi ? expf(s[h][j] - m_new) : 0.f;
          sum += p;
          s[h][j] = round_to<T>(p);
        }
        l[h] = l[h] * alpha + sum;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[h][c][e] *= alpha;
      }

      // acc += p * v over the tile's rows.
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int r = j * RPS + grp;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float vf[VEC];
          unpack<T, VEC>(*reinterpret_cast<const uint4*>(vs + r * D + (cl + LPR * c) * VEC), vf);
#pragma unroll
          for (int h = 0; h < G; ++h)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[h][c][e] = fmaf(s[h][j], vf[e], acc[h][c][e]);
        }
      }
      __syncwarp();  // every lane is done with this stage before it refills
    }
    cp_async_wait<0>();

    // Fold the row groups (a butterfly: every lane ends with the same bits),
    // then publish the warp's (m, l, acc).
#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[h][c][e] += __shfl_xor_sync(0xffffffffu, acc[h][c][e], o);
      }
    }
    if (grp == 0) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h < g) {
          if (cl == 0) {
            wml[(warp * g + h) * 2] = m[h];
            wml[(warp * g + h) * 2 + 1] = l[h];
          }
#pragma unroll
          for (int c = 0; c < CPL; ++c)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              wacc[(warp * g + h) * D + (cl + LPR * c) * VEC + e] = acc[h][c][e];
        }
      }
    }
  }
  __syncthreads();

  // Fold the warps in order.  Thread i takes outputs i, i + THREADS, ...
  constexpr int OUT_PER_THREAD = (G * D + THREADS - 1) / THREADS;
  float fo[OUT_PER_THREAD], fm[OUT_PER_THREAD], fl[OUT_PER_THREAD];
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    const int i = tid + j * THREADS;
    if (active && i < g * D) {
      const int h = i / D;
      const int dd = i - h * D;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wml[(w * g + h) * 2]);
      float lx = 0.f, ax = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float sc = expf(wml[(w * g + h) * 2] - mx);
        lx += wml[(w * g + h) * 2 + 1] * sc;
        ax += wacc[(w * g + h) * D + dd] * sc;
      }
      fo[j] = ax;
      fm[j] = mx;
      fl[j] = lx;
    }
  }

  if (cluster) {
    // The cluster's blocks are the splits of this (sequence, KV head):
    // each leaves its partial in its own shared memory, and block 0 folds
    // them in split order through distributed shared memory (no round trip
    // through L2, no ticket); every block waits at the second barrier until
    // block 0 has read it.
    namespace cg = cooperative_groups;
    cg::cluster_group clu = cg::this_cluster();
    float* bpart = wacc + WARPS * g * D;  // [g][D] acc, then [g][2] (m, l)
    if (active) {
#pragma unroll
      for (int j = 0; j < OUT_PER_THREAD; ++j) {
        const int i = tid + j * THREADS;
        if (i < g * D) {
          bpart[i] = fo[j];
          if (i % D == 0) {
            bpart[g * D + 2 * (i / D)] = fm[j];
            bpart[g * D + 2 * (i / D) + 1] = fl[j];
          }
        }
      }
    }
    clu.sync();
    if (split == 0) {
#pragma unroll
      for (int j = 0; j < OUT_PER_THREAD; ++j) {
        const int i = tid + j * THREADS;
        if (i < g * D) {
          const int h = i / D;
          float rm = NEG_INF, rl = 0.f, ra = 0.f;
#pragma unroll
          for (int sp = 0; sp < MAX_CLUSTER; ++sp) {
            if (sp < eff) {
              const float* rp = clu.map_shared_rank(bpart, sp);
              const float m = rp[g * D + 2 * h];
              const float m_new = fmaxf(rm, m);
              const float a = expf(rm - m_new), c = expf(m - m_new);
              rl = rl * a + rp[g * D + 2 * h + 1] * c;
              ra = ra * a + rp[i] * c;
              rm = m_new;
            }
          }
          emit(i, ra, rm, rl);  // eff == 0: (0, NEG_INF, 0)
        }
      }
    }
    clu.sync();
    return;
  }

  if (eff == 1) {
#pragma unroll
    for (int j = 0; j < OUT_PER_THREAD; ++j) {
      const int i = tid + j * THREADS;
      if (i < g * D) emit(i, fo[j], fm[j], fl[j]);
    }
    return;
  }

  const size_t grp_id = static_cast<size_t>(bi) * kvh + hk;
  const size_t part = grp_id * splits + split;
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    const int i = tid + j * THREADS;
    if (i < g * D) {
      part_o[part * g * D + i] = fo[j];
      if (i % D == 0) {
        part_ml[(part * g + i / D) * 2] = fm[j];
        part_ml[(part * g + i / D) * 2 + 1] = fl[j];
      }
    }
  }
  __syncthreads();  // the release below publishes every thread's partial
  if (tid == 0) is_last = draw_ticket(tickets + grp_id) == eff - 1;
  __syncthreads();
  if (!is_last) return;

  // The last block of the (sequence, KV head) folds the eff partials in
  // split order, online (a running max, as the warps do): chunks of
  // partials are staged in the free ring through L2 (other blocks wrote
  // them during this launch), FOLD loads in flight per thread, so a chunk
  // costs one round trip.
  constexpr int FOLD = 16;
  const int per = g * (D + 2);  // one partial: acc (g x D), then (m, l) per head
  const int spc = max(1, static_cast<int>(ring_bytes<T, D, MMA>() / sizeof(float)) / per);
  float* stage = reinterpret_cast<float*>(smem_raw);
  float rm[OUT_PER_THREAD], rl[OUT_PER_THREAD], ra[OUT_PER_THREAD];
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    rm[j] = NEG_INF;
    rl[j] = ra[j] = 0.f;
  }
  for (int s0 = 0; s0 < eff; s0 += spc) {
    const int total = min(spc, eff - s0) * per;
    for (int i0 = 0; i0 < total; i0 += FOLD * THREADS) {
      float v[FOLD];
#pragma unroll
      for (int u = 0; u < FOLD; ++u) {
        const int i = i0 + u * THREADS + tid;
        if (i < total) {
          const int sp = i / per, r = i - sp * per;
          const size_t pp = grp_id * splits + s0 + sp;
          v[u] = r < g * D ? __ldcg(part_o + pp * g * D + r)
                           : __ldcg(part_ml + pp * g * 2 + (r - g * D));
        }
      }
#pragma unroll
      for (int u = 0; u < FOLD; ++u) {
        const int i = i0 + u * THREADS + tid;
        if (i < total) stage[i] = v[u];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < OUT_PER_THREAD; ++j) {
      const int i = tid + j * THREADS;
      if (i < g * D) {
        const int h = i / D;
        for (int sp = 0; sp < total / per; ++sp) {
          const float* pt = stage + sp * per;
          const float m = pt[g * D + 2 * h];
          const float m_new = fmaxf(rm[j], m);
          const float a = expf(rm[j] - m_new), c = expf(m - m_new);
          rl[j] = rl[j] * a + pt[g * D + 2 * h + 1] * c;
          ra[j] = ra[j] * a + pt[i] * c;
          rm[j] = m_new;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    const int i = tid + j * THREADS;
    if (i < g * D) emit(i, ra[j], rm[j], rl[j]);
  }
  if (tid == 0) tickets[grp_id] = 0;
}

template <typename T, int D, int G, bool MMA>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   float* out_m, float* out_l, float* part_o, float* part_ml, int* tickets, int b,
                   int s, int kvh, int g, int splits, int fixed_rows, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D, MMA>(G);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, D, G, MMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(kvh),
                  static_cast<unsigned>(b));
  const int cluster = splits > 1 && splits <= MAX_CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<T, D, MMA>(g);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_kernel<T, D, G, MMA>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, out, out_m, out_l, part_o, part_ml, tickets, s, kvh, g,
      splits, fixed_rows, cluster, out_m != nullptr ? 1 : 0, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The register arrays are sized by G >= g.  bf16 at d = 64, 128 takes the
// tensor-core stream (G = 4 or 16, for the fold's registers); the plain-FMA
// stream takes f32 (G exact for g <= 4 at d = 64, 128, else the next of 8
// and 16) and bf16 at the other widths (G = 4 or 16).
template <typename T, int D>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, const int* lengths,
                       void* out, float* out_m, float* out_l, float* part_o, float* part_ml,
                       int* tickets, int b, int s, int kvh, int g, int splits, int fixed_rows,
                       float scale, cudaStream_t stream) {
#define DECODE_G(GG, MM) \
  return launch<T, D, GG, MM>(q, k, v, lengths, out, out_m, out_l, part_o, part_ml, tickets, b, s, kvh, g, splits, fixed_rows, scale, stream)
  constexpr bool WIDE = D == 64 || D == 128;
  if constexpr (WIDE && sizeof(T) == 2) {
    if (g <= 4) DECODE_G(4, true);
    DECODE_G(16, true);
  } else if constexpr (WIDE) {
    if (g == 1) DECODE_G(1, false);
    if (g == 2) DECODE_G(2, false);
    if (g == 3) DECODE_G(3, false);
    if (g <= 4) DECODE_G(4, false);
    if (g <= 8) DECODE_G(8, false);
    DECODE_G(16, false);
  } else {
    if (g <= 4) DECODE_G(4, false);
    DECODE_G(16, false);
  }
#undef DECODE_G
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const int* lengths,
                       void* out, float* out_m, float* out_l, float* part_o, float* part_ml,
                       int* tickets, int b, int s, int kvh, int g, int splits, int fixed_rows,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return dispatch_g<T, 16>(q, k, v, lengths, out, out_m, out_l, part_o, part_ml, tickets, b, s, kvh, g, splits, fixed_rows, scale, stream);
    case 32:
      return dispatch_g<T, 32>(q, k, v, lengths, out, out_m, out_l, part_o, part_ml, tickets, b, s, kvh, g, splits, fixed_rows, scale, stream);
    case 64:
      return dispatch_g<T, 64>(q, k, v, lengths, out, out_m, out_l, part_o, part_ml, tickets, b, s, kvh, g, splits, fixed_rows, scale, stream);
    case 128:
      return dispatch_g<T, 128>(q, k, v, lengths, out, out_m, out_l, part_o, part_ml, tickets, b, s, kvh, g, splits, fixed_rows, scale, stream);
    case 256:
      return dispatch_g<T, 256>(q, k, v, lengths, out, out_m, out_l, part_o, part_ml, tickets, b, s, kvh, g, splits, fixed_rows, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace {

int launch_any(const void* q, const void* k, const void* v, const int* lengths, void* out,
               float* out_m, float* out_l, float* part_o, float* part_ml, int* tickets,
               int dtype, int b, int s, int kvh, int g, int d, int splits, int fixed_rows,
               float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || s < 1 || kvh < 1 || g < 1 || g > MAX_GROUP || splits < 1 ||
      splits > 65535 || kvh > 65535 || b > 65535 || fixed_rows < 0 ||
      (fixed_rows > 0 && static_cast<long long>(fixed_rows) * splits < s) ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr || tickets == nullptr)) ||
      ((out_m == nullptr) != (out_l == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = dispatch_d<float>(d, q, k, v, lengths, out, out_m, out_l, part_o, part_ml, tickets, b, s, kvh, g, splits, fixed_rows, scale, stream);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, lengths, out, out_m, out_l, part_o, part_ml, tickets, b, s, kvh, g, splits, fixed_rows, scale, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

// q: (b, kv*g, d); k, v: (b, s, kv, d), contiguous, 16-byte aligned;
// lengths: (b,) int32; out: (b, kv*g, d).  dtype: 0 = float32, 1 =
// bfloat16.  fixed_rows: 0 splits each sequence by its length, else the
// rows of every split.  When splits > 1, part_o (b, kv, splits, g, d) and
// part_ml (b, kv, splits, g, 2) are f32 scratch and tickets holds b * kv
// zeroed ints (each launch leaves them at 0); all three are unused
// otherwise.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* lengths, void* out, float* part_o,
                                       float* part_ml, int* tickets, int dtype, int b, int s,
                                       int kvh, int g, int d, int splits, int fixed_rows,
                                       float scale, void* stream_ptr) {
  return launch_any(q, k, v, lengths, out, nullptr, nullptr, part_o, part_ml, tickets, dtype, b,
                    s, kvh, g, d, splits, fixed_rows, scale, stream_ptr);
}

// K2p, the same launch with the fold's state as its output: o (b, kv*g, d)
// the unnormalised sum_s exp(s - m) v_s, m and l (b, kv*g) the running max
// and sum, all f32 (kernels/decode_attention/ref.py::decode_attention_partial);
// a row with lengths[b] == 0 gets o = 0, m = NEG_INF, l = 0 exactly.  The
// other arguments are decode_attention_launch's.
extern "C" int decode_attention_partial_launch(const void* q, const void* k, const void* v,
                                               const int* lengths, float* o, float* m,
                                               float* l, float* part_o, float* part_ml,
                                               int* tickets, int dtype, int b, int s, int kvh,
                                               int g, int d, int splits, int fixed_rows,
                                               float scale, void* stream_ptr) {
  if (o == nullptr || m == nullptr || l == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(q, k, v, lengths, o, m, l, part_o, part_ml, tickets, dtype, b, s, kvh, g, d,
                    splits, fixed_rows, scale, stream_ptr);
}
