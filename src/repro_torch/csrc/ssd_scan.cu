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
// Two kernels, chosen by the wrapper before any launch
// (kernels/ssd_scan/ops.py::kernel_for): ssd_scan_tc_kernel for bf16 at the
// model shapes (p = 64, n in {64, 128}, chunk 64 or 128) on the tensor
// cores, ssd_scan_kernel (plain f32 FMAs) for f32 and the other shapes.
//
// Bound: HBM bytes at the serving shapes (x and y dominate; 0.052 ms at
// mamba2-1.3b's 16 x 512 prefill), with the operations (~30 GFLOP over the
// causal triangles) close behind at the bf16 tensor-core rate.
//
// ssd_scan_tc_kernel (bf16).  The plain-FMA kernel spends ~0.6 shared
// loads per f32 FMA and recomputes C.B^T for every head; this one puts all
// four products on the tensor cores (wgmma m64nNk16, f32 accumulators),
// computes C.B^T once for the heads a block carries, and keeps operands in
// bf16 shared memory:
//
//   * One block of two warpgroups per (pair of heads of one group,
//     sequence): 16 x 32 = 512 blocks at the serving shapes, one per SM at
//     a time (~165 KB of shared memory at n = 128).  The block walks the
//     chunks in order, as the TPU grid does; each head's state S (P x n f32)
//     stays in the accumulator registers of one warpgroup for the whole
//     walk and goes to HBM once, at the end.
//   * TMA loads each chunk's C and B (q x n) and both heads' x (q x 64)
//     into 128B-swizzled tiles on one mbarrier; the next chunk's loads are
//     issued as soon as the current chunk is done with the tiles.  dt is
//     read with plain loads while they fly.  dt * A is cumsummed by one warp
//     per head in ssd_scan_kernel's fixed order.
//   * C.B^T: warpgroup w takes rows [64 w, 64 w + 64) of the chunk (both
//     at q = 64, one head each), A = C and B = B both K-major, the columns
//     above its rows skipped.  It stays in registers for both heads.
//   * y: acc = C.S^T (A = C, B = S K-major, S rounded to bf16), scaled per
//     row by exp(L_t); then M = C.B^T exp(L_t - L_s) dt_s, selected to 0
//     above the diagonal (never multiplied by a mask: exp overflows there
//     at A = -64), is rounded to bf16 in registers, where the accumulator
//     layout is already wgmma's A-register layout, and acc += M.x with x as
//     an MN-major B (the transpose bit).  y leaves from registers in bf16.
//   * The state update S' = exp(L_q) S + (w x)^T B, w_s = exp(L_q - L_s)
//     dt_s: w x overwrites x in shared memory (per row of the swizzled tile,
//     so the swizzle needs no thought), as two bf16 terms hi = bf16(w x)
//     and lo = bf16(w x - hi); two wgmmas per K-step, A = w x and B = B
//     both MN-major (transposed).  One bf16 rounding of w x would cost 2^-9
//     of every term: at the serving shape the final state would then miss
//     its 3e-4 tolerance (tests/test_torch_ssd.py emulates both schemes).
//     Rounding M and S to bf16 for y is within y's 2e-2.
//   * Every sum runs in a fixed order and nothing is atomic: the same input
//     gives the same bits on every launch.
//   * Descriptors follow flash_attention.cu's, which the card has run: the
//     128B swizzle, 1024-byte aligned tiles, 8-row groups 1024 bytes apart;
//     K-major K-steps of 32 bytes inside the atom, MN-major K-steps of 16
//     rows (2 KB) with 64-column boxes a leading byte offset apart.
//     Shared memory written by threads (w x, bf16 S) is fenced to the async
//     proxy before a wgmma reads it.
//
// ssd_scan_kernel (f32, and bf16 at other shapes) runs plain f32 FMAs on
// operands read from shared memory, about 0.6 loads per FMA, so
// shared-memory loads and their latency bound it, far above the HBM bound:
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

#include <cuda.h>  // CUtensorMap and its enums; no driver symbol is linked
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


// --------------------------------------------------------------------------
// ssd_scan_tc_kernel: bf16 on the tensor cores (wgmma, TMA, mbarriers).

namespace tc {

constexpr int P = 64;           // head dim: one 128-byte row of bf16
constexpr int TC_THREADS = 256;  // two warpgroups
constexpr uint32_t SW_ROWS8 = 1024;  // 8 swizzled 128-byte rows
constexpr uint32_t S_BOX = 64 * 128;  // 64 rows x 64 bf16 columns

template <int N, int Q>
struct Layout {
  static constexpr int nb = N / 64;                    // 64-column boxes of B, C, S
  static constexpr uint32_t box = Q * 128;             // Q rows x 64 bf16 columns
  static constexpr uint32_t bc_tile = nb * box;        // Q x N bf16
  static constexpr uint32_t x_tile = box;              // Q x P bf16
  static constexpr uint32_t s_tile = nb * S_BOX;       // P x N bf16
  static constexpr uint32_t c_off = 0;
  static constexpr uint32_t b_off = c_off + bc_tile;
  static constexpr uint32_t x_off = b_off + bc_tile;   // x of heads 0, 1 (then w x, hi)
  static constexpr uint32_t xl_off = x_off + 2 * x_tile;  // w x, lo
  static constexpr uint32_t s_off = xl_off + 2 * x_tile;  // bf16 state of heads 0, 1
  static constexpr uint32_t f_off = s_off + 2 * s_tile;   // dt, L, exp(L), w: [4][2][Q] f32
  static constexpr uint32_t bar_off = f_off + 4 * 2 * Q * 4;
  static constexpr size_t smem = bar_off + 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
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
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that owns it.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
template <int K>
__device__ __forceinline__ void pin_all(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) pin(r[i]);
}

// A wgmma shared-memory descriptor for a 128B-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = 128B.
// K-major: 8-row groups 1024 bytes apart (sbo), K-steps of 32 bytes inside
// the atom.  MN-major: 64-element MN blocks lbo apart, 8 K-rows 1024 bytes
// apart, K-steps of 16 rows = 2 KB.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64), both bf16 from shared
// memory; TA / TB = 1 reads that operand MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 128, f32) += A (64 x 16) . B (16 x 128), both bf16 from shared
// memory, both MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n128_tt(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, bf16 from
// shared memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
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

// The state update of one head: S (P x N) += A^T . B with A = (w x) (Q x P)
// and B the chunk's B (Q x N), both MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_state(float (&s)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128) {
    wgmma_ss_n128_tt(s, da, db);
  } else {
    wgmma_ss_n64<1, 1>(s, da, db);
  }
}

// Grid (head pairs x groups, batch).  A block takes two heads of one group
// (one if the group's head count is odd) of one sequence and walks its
// chunks; warpgroup w computes the rows [64 w, 64 w + 64) of every head's y
// when Q = 128 (head w's rows when Q = 64) and carries head w's state.
template <int N, int Q>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_scan_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap b_map,
                   const __grid_constant__ CUtensorMap c_map, const float* __restrict__ dt,
                   const float* __restrict__ A, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ state, int l, int h, int hpg, int pairs) {
  using LY = Layout<N, Q>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t c_s = base + LY::c_off;
  const uint32_t b_s = base + LY::b_off;
  const uint32_t bar = base + LY::bar_off;
  float* dts = reinterpret_cast<float*>(smem + LY::f_off);  // [2][Q]
  float* Ls = dts + 2 * Q;
  float* eL = Ls + 2 * Q;
  float* ws = eL + 2 * Q;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gi = blockIdx.x / pairs;
  const int h0 = gi * hpg + 2 * (blockIdx.x % pairs);
  const int nh = min(2, gi * hpg + hpg - h0);  // heads in this block
  const int bi = blockIdx.y;
  const int nc = l / Q;
  // Accumulator fragment of wgmma m64nN: thread (warp w of its warpgroup,
  // lane) holds rows r0 = 16 w + lane / 4 and r0 + 8 of the 64; element i
  // sits in row r0 + 8 ((i >> 1) & 1) and column 8 (i >> 2) + c2 + (i & 1).
  const int r0 = (warp & 3) * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  const int rt = Q == 128 ? wg : 0;  // this warpgroup's 64-row tile of y

  const CUtensorMap* xm = &x_map;
  const CUtensorMap* bm = &b_map;
  const CUtensorMap* cm = &c_map;
  // Chunk c's C, B and x tiles, one mbarrier phase per chunk (one thread).
  auto issue = [=](int c) {
    mbar_expect_tx(bar, 2 * LY::bc_tile + nh * LY::x_tile);
#pragma unroll
    for (int x = 0; x < LY::nb; ++x) {
      tma_load_4d(c_s + x * LY::box, cm, bar, 64 * x, gi, c * Q, bi);
      tma_load_4d(b_s + x * LY::box, bm, bar, 64 * x, gi, c * Q, bi);
    }
    for (int hh = 0; hh < nh; ++hh)
      tma_load_4d(base + LY::x_off + hh * LY::x_tile, xm, bar, 0, h0 + hh, c * Q, bi);
  };

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) issue(0);

  float st[N / 2];  // this warpgroup's head's state, P x N f32
#pragma unroll
  for (int i = 0; i < N / 2; ++i) st[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const size_t row0 = static_cast<size_t>(bi) * l + static_cast<size_t>(c) * Q;
    for (int i = tid; i < nh * Q; i += TC_THREADS) {
      const int hh = i / Q, t = i - hh * Q;
      dts[hh * Q + t] = dt[(row0 + t) * h + h0 + hh];
    }
    __syncthreads();
    if (warp < nh) {
      // Inclusive cumsum of dt * A in a fixed order (ssd_scan_kernel's):
      // each lane sums its run of consecutive steps, then a shuffle scan
      // adds the runs before it.
      const float a_h = A[h0 + warp];
      constexpr int per = Q / 32;
      const int lo = lane * per;
      float* L = Ls + warp * Q;
      const float* d = dts + warp * Q;
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < per; ++i) {
        run += d[lo + i] * a_h;
        L[lo + i] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane > 0) {
#pragma unroll
        for (int i = 0; i < per; ++i) L[lo + i] += prev;
      }
    }
    __syncthreads();
    for (int i = tid; i < nh * Q; i += TC_THREADS) {
      const int hh = i / Q;
      const float LQ = Ls[hh * Q + Q - 1];
      eL[i] = expf(Ls[i]);
      ws[i] = expf(LQ - Ls[i]) * dts[i];
    }
    __syncthreads();
    mbar_wait(bar, c & 1);

    // C.B^T for this warpgroup's rows, once for every head of the block:
    // columns [0, 64) in cb0, [64, 128) in cb1 (rows past 63 only).
    float cb0[32], cb1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) cb0[i] = cb1[i] = 0.f;
    pin_all(cb0);
    pin_all(cb1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t koff = (kk >> 2) * LY::box + (kk & 3) * 32;
      const uint64_t da = sw128_desc(c_s + koff + rt * 64 * 128, 16, SW_ROWS8);
      wgmma_ss_n64<0, 0>(cb0, da, sw128_desc(b_s + koff, 16, SW_ROWS8));
      if (rt == 1) wgmma_ss_n64<0, 0>(cb1, da, sw128_desc(b_s + koff + 64 * 128, 16, SW_ROWS8));
    }
    wg_commit();
    wg_wait_all();
    pin_all(cb0);
    pin_all(cb1);

    for (int hh = 0; hh < nh; ++hh) {
      if (Q == 64 && hh != wg) continue;  // at Q = 64 warpgroup w takes head w
      const float* L = Ls + hh * Q;
      const float* d = dts + hh * Q;
      const int t0 = rt * 64 + r0, t1 = t0 + 8;
      const uint32_t x_s = base + LY::x_off + hh * LY::x_tile;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      if (c > 0) {
        // exp(L_t) (C_t . S^T): S in bf16, K-major (P rows x N).
        const uint32_t s_s = base + LY::s_off + hh * LY::s_tile;
        pin_all(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          const uint32_t koff = (kk >> 2) * LY::box + (kk & 3) * 32;
          wgmma_ss_n64<0, 0>(acc, sw128_desc(c_s + koff + rt * 64 * 128, 16, SW_ROWS8),
                             sw128_desc(s_s + (kk >> 2) * S_BOX + (kk & 3) * 32, 16, SW_ROWS8));
        }
        wg_commit();
        wg_wait_all();
        pin_all(acc);
        const float e0 = eL[hh * Q + t0], e1 = eL[hh * Q + t1];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? e1 : e0;
      }

      // M = C.B^T exp(L_t - L_s) dt_s for s <= t, selected to 0 above the
      // diagonal (never multiplied by a mask), rounded to bf16 as wgmma's A
      // registers: K-step kk holds keys 16 kk .. 16 kk + 15.
      const float Lt0 = L[t0], Lt1 = L[t1];
      uint32_t pa[Q / 16][4];
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        if (kk < 4 * (rt + 1)) {
          float mv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int s = 16 * kk + 8 * (j >> 2) + c2 + (j & 1);
            const int t = (j & 2) ? t1 : t0;
            const float cbv = (kk < 4 ? cb0 : cb1)[8 * (kk & 3) + j];
            const float e = __expf(((j & 2) ? Lt1 : Lt0) - L[s]) * d[s];
            mv[j] = s <= t ? cbv * e : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(mv[2 * j], mv[2 * j + 1]);
        }
      }
      // y += M . x: x MN-major (P contiguous), 16 steps of the chunk per K-step.
      pin_all(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        if (kk < 4 * (rt + 1))
          wgmma_rs_n64_tb(acc, pa[kk], sw128_desc(x_s + kk * 2048, LY::box, SW_ROWS8));
      }
      wg_commit();
      wg_wait_all();
      pin_all(acc);

      __nv_bfloat16* y0 = y + ((row0 + t0) * h + h0 + hh) * P;
      __nv_bfloat16* y1 = y + ((row0 + t1) * h + h0 + hh) * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(y0 + 8 * j + c2) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(y1 + 8 * j + c2) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    __syncthreads();  // every wgmma and thread is done with C, x and S

    // w x in place of x, split in two bf16 terms: hi = bf16(w x) and lo =
    // bf16(w x - hi), so the state update keeps ~16 bits of each term
    // (one bf16 rounding would cost 2^-9 of every term).  The swizzle
    // permutes 16-byte chunks within a 128-byte row: chunk i is row i / 8.
    for (int i = tid; i < nh * Q * 8; i += TC_THREADS) {
      const int hh = i / (Q * 8), k = i - hh * Q * 8;
      const float w = ws[hh * Q + k / 8];
      uint4* xp = reinterpret_cast<uint4*>(smem + LY::x_off + hh * LY::x_tile) + k;
      uint4* lp = reinterpret_cast<uint4*>(smem + LY::xl_off + hh * LY::x_tile) + k;
      uint4 v = *xp, lo;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
      __nv_bfloat162* el = reinterpret_cast<__nv_bfloat162*>(&lo);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(e[j]);
        const float a = f.x * w, b = f.y * w;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
        const float2 fh = __bfloat1622float2(hi);
        e[j] = hi;
        el[j] = __floats2bfloat162_rn(a - fh.x, b - fh.y);
      }
      *xp = v;
      *lp = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S' = exp(L_Q) S + (w x)^T B, for this warpgroup's head.
    if (wg < nh) {
      const float eQ = expf(Ls[wg * Q + Q - 1]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) st[i] *= eQ;
      const uint32_t xh = base + LY::x_off + wg * LY::x_tile;
      const uint32_t xl = base + LY::xl_off + wg * LY::x_tile;
      pin_all(st);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const uint64_t db = sw128_desc(b_s + kk * 2048, LY::box, SW_ROWS8);
        wgmma_state<N>(st, sw128_desc(xh + kk * 2048, LY::box, SW_ROWS8), db);
        wgmma_state<N>(st, sw128_desc(xl + kk * 2048, LY::box, SW_ROWS8), db);
      }
      wg_commit();
      wg_wait_all();
      pin_all(st);
      if (c + 1 < nc) {
        // bf16 S for the next chunk's C.S^T, K-major with the 128B swizzle:
        // row p, 16-byte chunk j of a box at chunk j ^ (p & 7).
        unsigned char* s_s = smem + LY::s_off + wg * LY::s_tile;
#pragma unroll
        for (int i = 0; i < N / 2; i += 2) {
          const int p = r0 + 8 * ((i >> 1) & 1);
          const int k = 8 * (i >> 2) + c2;
          const int kc = k & 63;
          *reinterpret_cast<uint32_t*>(s_s + (k >> 6) * S_BOX + p * 128 +
                                       (((kc >> 3) ^ (p & 7)) << 4) + (kc & 7) * 2) =
              pack_bf16(st[i], st[i + 1]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
    }
    __syncthreads();  // B, x, w x and S are free: load the next chunk
    if (tid == 0 && c + 1 < nc) issue(c + 1);
  }

  if (wg < nh) {
    float* out = state + (static_cast<size_t>(bi) * h + h0 + wg) * P * N;
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
      const int p = r0 + 8 * ((i >> 1) & 1);
      const int k = 8 * (i >> 2) + c2;
      *reinterpret_cast<float2*>(out + p * N + k) = make_float2(st[i], st[i + 1]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so no -lcuda is needed.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (b, rows, heads, d) bf16 tensor as a 4-D map with 64 x 1 x box_rows x 1
// boxes (64 columns = 128 bytes, the 128B swizzle's limit).
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int b, int rows, int heads,
              int d, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(heads) * d * 2,
                                 static_cast<cuuint64_t>(rows) * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N, int Q>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B, const void* C,
                   void* y, float* state, int b, int l, int h, int g, cudaStream_t stream) {
  using LY = Layout<N, Q>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_tc_kernel<N, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(LY::smem));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap x_map, b_map, c_map;
  if (!make_map(encode, &x_map, x, b, l, h, P, Q) || !make_map(encode, &b_map, B, b, l, g, N, Q) ||
      !make_map(encode, &c_map, C, b, l, g, N, Q)) {
    return cudaErrorInvalidValue;
  }
  const int hpg = h / g;
  const int pairs = (hpg + 1) / 2;
  ssd_scan_tc_kernel<N, Q><<<dim3(static_cast<unsigned>(pairs * g), static_cast<unsigned>(b)),
                             TC_THREADS, LY::smem, stream>>>(
      x_map, b_map, c_map, dt, A, static_cast<__nv_bfloat16*>(y), state, l, h, hpg, pairs);
  return cudaGetLastError();
}

}  // namespace tc


// --------------------------------------------------------------------------
// K4b: the backward of the chunked scan.  Two routes, chosen by the wrapper
// before any launch (kernels/ssd_scan/ops.py::kernel_for_bwd): bf16 at the
// models' shapes (p = 64, n in {64, 128}, chunk 64 or 128) on the tensor
// cores (namespace bwd_tc, below), f32 and every other shape on the plain
// f32 FMAs of namespace bwd, described here.
//
// Replaces no Pallas kernel: the TPU package differentiates the plain
// chunked version (src/repro/kernels/ssd_scan/ref.py:60, ssd_chunked) with
// jax.grad.  The formulas are kernels/ssd_scan/ref.py::ssd_bwd_ref's: per
// chunk, with S_in the state entering it, L = cumsum(dt A), D[t,s] =
// exp(L_t - L_s) (s <= t), dot[t,s] = dy_t . x_s, G = C B^T, w_s = exp(L_q -
// L_s) dt_s and u_s = dS_out B_s,
//
//   dx_s  = sum_t G D dt_s [t,s] dy_t + w_s u_s
//   dC_t  = sum_s dot D dt_s [t,s] B_s + exp(L_t) S_in^T dy_t
//   dB_s  = dt_s sum_t dot D [t,s] C_t + w_s dS_out^T x_s
//   dS_in = exp(L_q) dS_out + sum_t exp(L_t) dy_t (x) C_t
//   ddt, dA through dt's own factors and through L (a reverse cumsum of dL;
//   the terms of dL that cancel exactly are left out, as there).
//
// The plain-FMA route: five launches on the stream, every sum in a fixed
// order and nothing atomic, so two calls give the same bits:
//
//   1. ssd_bwd_cb_kernel, one block per (chunk, group, batch): G = C B^T
//      below the diagonal, once per group (mamba2's 64 heads share one).
//   2. ssd_bwd_state_kernel, one block per (head, batch, 16 rows of the
//      state): the rows of S evolve independently, so the block sweeps the
//      chunks forward, writing the state entering each chunk (the states
//      are recomputed here, not kept by the forward: the forward kernels
//      stay as they are and nothing is held between the two passes), then
//      backward, writing the state's cotangent leaving each chunk.
//   3. ssd_bwd_chunk_kernel, one block per (chunk, head, batch): with the
//      chunk's S_in and dS_out from pass 2 the chunks are independent; the
//      block writes dx and ddt (its own) and its head's part of dB, dC and
//      dA.  Entries above the diagonal are never computed: the exponent is
//      selected before the exp (at A = -64, exp(L_t - L_s) above the
//      diagonal overflows, and 0 * inf in a gradient is NaN).
//   4. ssd_bwd_group_kernel sums dB and dC over each group's heads in head
//      order; 5. ssd_bwd_da_kernel sums dA over batch and chunks in order.
//
// Bound at mamba2-1.3b's training shape (1 x 4096, 64 heads of 64, state
// 128, chunk 128, bf16): 34.5 GFLOP over the causal triangles (recomputing
// C B^T and the states included), 0.035 ms at the bf16 tensor-core rate,
// against 0.107 GB of inputs and outputs, 0.032 ms at the HBM rate.  This
// route runs on plain f32 FMAs with operands in shared memory (about one
// shared load per FMA) and takes 13.7 ms there on an H100 SXM at 700 W
// (chip_smoke.py phase 18), ~400x the bound: the chunk kernel ~11.4 ms (one
// 203 KB block of 8 warps per SM cannot hide its shared loads' latency),
// the state sweep ~2.0 ms.  Its f32 scratch (~0.4 GB there, chiefly the
// per-head dB and dC) is written once and read once.  The tensor-core route
// takes 0.44 ms at that shape (below).

namespace bwd {

constexpr int NTW = 32;        // state columns per tile of the chunk kernel
constexpr int NTS = NTW + 1;   // their row stride: conflict-free columns
constexpr int PT = 16;         // state rows per block of the sweep kernel
constexpr int KR = MAX_Q / 8;  // rows per warp in the chunk kernel
constexpr int SE = PT * MAX_N / THREADS;  // state entries per sweep thread

__host__ __device__ constexpr size_t scratch_floats(int b, int l, int h, int p, int g, int n,
                                                    int q) {
  return static_cast<size_t>(b) * g * (l / q) * q * q +
         2 * static_cast<size_t>(b) * h * (l / q) * p * n +
         2 * static_cast<size_t>(b) * l * h * n + static_cast<size_t>(b) * h * (l / q);
}

__host__ __device__ constexpr size_t chunk_smem_floats(int q, int p) {
  return 2 * static_cast<size_t>(p) * (q | 1) + static_cast<size_t>(q) * (q | 1) +
         static_cast<size_t>(ROWS) * (q | 1) + 2 * static_cast<size_t>(q) * NTS +
         2 * static_cast<size_t>(p) * NTS + 6 * static_cast<size_t>(q) + THREADS;
}

__host__ __device__ constexpr size_t cb_smem_floats(int q, int n) {
  return static_cast<size_t>(n) * (q | 1) + static_cast<size_t>(q) * (n | 1);
}

__host__ __device__ constexpr size_t state_smem_floats(int q, int n) {
  return static_cast<size_t>(q) * PT + static_cast<size_t>(q) * n + 2 * static_cast<size_t>(q);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Inclusive cumsum of dt * a over q steps by one warp, in the forward
// kernel's fixed order: each lane sums its run, a shuffle scan adds the
// runs before it.
__device__ void chunk_cumsum(const float* dts, float* Ls, float a, int q, int lane) {
  const int per = (q + 31) / 32, lo = lane * per;
  float run = 0.f;
  for (int i = 0; i < per; ++i) {
    if (lo + i < q) {
      run += dts[lo + i] * a;
      Ls[lo + i] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane > 0) {
    for (int i = 0; i < per; ++i) {
      if (lo + i < q) Ls[lo + i] += prev;
    }
  }
}

// 1. G[t][s] = C_t . B_s for s <= t (0 above), per (batch, group, chunk).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_cb_kernel(const T* __restrict__ B, const T* __restrict__ C, float* __restrict__ G,
                  int l, int g, int n, int q) {
  extern __shared__ float smem[];
  const int QS = q | 1, NS = n | 1;
  float* bT = smem;          // [n][QS]: B_s[k] at bT[k * QS + s]
  float* cs = bT + n * QS;   // [q][NS]
  const int c = blockIdx.x, gi = blockIdx.y, bi = blockIdx.z, nc = l / q;
  const size_t row0 = static_cast<size_t>(bi) * l + static_cast<size_t>(c) * q;
  for (int i = threadIdx.x; i < q * n; i += THREADS) {
    const int s = i / n, k = i - s * n;
    const size_t src = ((row0 + s) * g + gi) * n + k;
    bT[k * QS + s] = to_f32<T>(B[src]);
    cs[s * NS + k] = to_f32<T>(C[src]);
  }
  __syncthreads();
  float* out = G + ((static_cast<size_t>(bi) * g + gi) * nc + c) * q * q;
  for (int i = threadIdx.x; i < q * q; i += THREADS) {
    const int t = i / q, s = i - t * q;
    float acc = 0.f;
    if (s <= t) {
      const float* cr = cs + t * NS;
      for (int k = 0; k < n; ++k) acc = fmaf(cr[k], bT[k * QS + s], acc);
    }
    out[i] = acc;
  }
}

// 2. The state entering each chunk, then the state's cotangent leaving it,
// for rows [p0, p0 + PT) of one (batch, head).  dstate (b, h, p, n) may be
// null (a zero cotangent).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ B,
                     const T* __restrict__ C, const T* __restrict__ dy,
                     const float* __restrict__ dstate, float* __restrict__ states,
                     float* __restrict__ dstates, int l, int h, int p, int g, int n, int q) {
  extern __shared__ float smem[];
  float* vs = smem;          // [q][PT]: w_s x_s, then exp(L_t) dy_t, this block's rows
  float* ws = vs + q * PT;   // [q][n]: B, then C
  float* Ls = ws + q * n;
  float* dts = Ls + q;
  const int hh = blockIdx.x, bi = blockIdx.y, p0 = blockIdx.z * PT;
  const int nc = l / q, gi = hh / (h / g), tid = threadIdx.x;
  const int pr = min(PT, p - p0);
  const float a_h = A[hh];
  int jr[SE], kc[SE];  // this thread's state entries: row p0 + jr, column kc
#pragma unroll
  for (int m = 0; m < SE; ++m) {
    const int e = tid + THREADS * m;
    jr[m] = e / n;
    kc[m] = e - jr[m] * n;
  }
  const size_t head = static_cast<size_t>(bi) * h + hh;
  float S[SE];
#pragma unroll
  for (int m = 0; m < SE; ++m) S[m] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    const bool fwd = pass == 0;
    const T* vin = fwd ? x : dy;
    const T* win = fwd ? B : C;
    float* out = fwd ? states : dstates;
    if (!fwd) {
#pragma unroll
      for (int m = 0; m < SE; ++m) {
        S[m] = (dstate != nullptr && jr[m] < pr)
                   ? dstate[(head * p + p0 + jr[m]) * n + kc[m]] : 0.f;
      }
    }
    for (int it = 0; it < nc; ++it) {
      const int c = fwd ? it : nc - 1 - it;
      const size_t row0 = static_cast<size_t>(bi) * l + static_cast<size_t>(c) * q;
      __syncthreads();  // the previous chunk is done with the staged inputs
      for (int i = tid; i < q; i += THREADS) dts[i] = dt[(row0 + i) * h + hh];
      __syncthreads();
      if (tid < 32) chunk_cumsum(dts, Ls, a_h, q, tid);
      __syncthreads();
      const float LQ = Ls[q - 1];
      for (int i = tid; i < q * PT; i += THREADS) {
        const int s = i / PT, j = i - s * PT;
        const float f = fwd ? expf(LQ - Ls[s]) * dts[s] : expf(Ls[s]);
        vs[i] = j < pr ? f * to_f32<T>(vin[((row0 + s) * h + hh) * p + p0 + j]) : 0.f;
      }
      for (int i = tid; i < q * n; i += THREADS) {
        const int s = i / n, k = i - s * n;
        ws[i] = to_f32<T>(win[((row0 + s) * g + gi) * n + k]);
      }
      __syncthreads();
      float acc[SE];
#pragma unroll
      for (int m = 0; m < SE; ++m) acc[m] = 0.f;
      for (int s = 0; s < q; ++s) {
#pragma unroll
        for (int m = 0; m < SE; ++m) {
          if (jr[m] < pr) acc[m] = fmaf(vs[s * PT + jr[m]], ws[s * n + kc[m]], acc[m]);
        }
      }
      // Forward: S_in of chunk c, then S_out = exp(L_q) S_in + acc.
      // Backward: dS_out of chunk c, then dS_in = exp(L_q) dS_out + acc.
      const float eQ = expf(LQ);
      float* o = out + (head * nc + c) * p * n;
#pragma unroll
      for (int m = 0; m < SE; ++m) {
        if (jr[m] < pr) {
          o[(p0 + jr[m]) * n + kc[m]] = S[m];
          S[m] = fmaf(eQ, S[m], acc[m]);
        }
      }
    }
  }
}

// 3. One chunk of one (batch, head): dx and ddt, and the head's part of dB,
// dC (f32, (b, l, h, n)) and dA (f32, (b, h, nc)).  Warp w takes rows
// w, w + 8, ... of every per-step quantity; lanes take columns.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ B,
                     const T* __restrict__ C, const T* __restrict__ dy,
                     const float* __restrict__ G, const float* __restrict__ states,
                     const float* __restrict__ dstates, T* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dBp, float* __restrict__ dCp,
                     float* __restrict__ dAp, int l, int h, int p, int g, int n, int q) {
  extern __shared__ float smem[];
  const int QS = q | 1;
  float* xT = smem;            // [p][QS]: x_s[j] at xT[j * QS + s]
  float* dyT = xT + p * QS;    // [p][QS]
  float* wdd = dyT + p * QS;   // [q][QS]: dot[t][s] exp(L_t - L_s), s <= t
  float* mt = wdd + q * QS;    // [ROWS][QS]: a row tile of G, then of G D dt
  float* bt = mt + ROWS * QS;  // [q][NTS]: a column tile of B
  float* ct = bt + q * NTS;    // [q][NTS]: of C
  float* sn = ct + q * NTS;    // [p][NTS]: of S_in
  float* dn = sn + p * NTS;    // [p][NTS]: of dS_out
  float* Ls = dn + p * NTS;
  float* dts = Ls + q;
  float* eL = dts + q;         // exp(L_t)
  float* rq = eL + q;          // exp(L_q - L_s)
  float* dL = rq + q;
  float* rs = dL + q;          // r_s = exp(L_q - L_s) x_s . u_s
  float* red = rs + q;         // one partial per thread

  const int c = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int nc = l / q, gi = hh / (h / g);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = static_cast<size_t>(bi) * l + static_cast<size_t>(c) * q;
  const size_t head = static_cast<size_t>(bi) * h + hh;
  const float a_h = A[hh];

  for (int i = tid; i < q * p; i += THREADS) {
    const int t = i / p, j = i - t * p;
    const size_t src = ((row0 + t) * h + hh) * p + j;
    xT[j * QS + t] = to_f32<T>(x[src]);
    dyT[j * QS + t] = to_f32<T>(dy[src]);
  }
  for (int i = tid; i < q; i += THREADS) {
    dts[i] = dt[(row0 + i) * h + hh];
    dL[i] = 0.f;
  }
  __syncthreads();
  if (tid < 32) chunk_cumsum(dts, Ls, a_h, q, tid);
  __syncthreads();
  const float LQ = Ls[q - 1];
  for (int i = tid; i < q; i += THREADS) {
    eL[i] = expf(Ls[i]);
    rq[i] = expf(LQ - Ls[i]);
  }

  // (a) wdd[t][s] = (dy_t . x_s) exp(L_t - L_s) for s <= t; nothing above.
  for (int t = warp; t < q; t += 8) {
    float acc[MAX_Q / 32];
#pragma unroll
    for (int m = 0; m < MAX_Q / 32; ++m) acc[m] = 0.f;
    const int mn = t / 32 + 1;
    for (int j = 0; j < p; ++j) {
      const float dv = dyT[j * QS + t];
      const float* xr = xT + j * QS;
#pragma unroll
      for (int m = 0; m < MAX_Q / 32; ++m) {
        if (m < mn) acc[m] = fmaf(dv, xr[min(lane + 32 * m, q - 1)], acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < MAX_Q / 32; ++m) {
      const int s = lane + 32 * m;
      if (m < mn && s <= t) wdd[t * QS + s] = acc[m] * expf(Ls[t] - Ls[s]);
    }
  }
  __syncthreads();

  // (b) Row tiles of G: dL_t += sum_{s < t} wdd G dt_s (row sums), the
  // column sums of wdd G below the diagonal (dt_s times them leaves dL_s)
  // and the diagonal apart (ddt's own term takes both), then M = G D dt
  // and dx_s += sum_{t >= s} M[t][s] dy_t.  W[t][t] would enter dL_t with
  // both signs: left out, it cannot leave its rounding behind, which at
  // A = -64 (where it is dL's largest term) would cost dA ~3e-3 in f32.
  const float* Gc = G + ((static_cast<size_t>(bi) * g + gi) * nc + c) * q * q;
  float colg = 0.f, diag = 0.f;  // thread s < q
  float dxa[KR][2];  // rows s = warp + 8 k, columns j = lane + 32 m
#pragma unroll
  for (int k = 0; k < KR; ++k) dxa[k][0] = dxa[k][1] = 0.f;
  for (int t0 = 0; t0 < q; t0 += ROWS) {
    const int te = min(t0 + ROWS, q);
    for (int i = tid; i < (te - t0) * q; i += THREADS) {
      const int r = i / q, s = i - r * q;
      mt[r * QS + s] = Gc[static_cast<size_t>(t0 + r) * q + s];
    }
    __syncthreads();
    for (int t = t0 + warp; t < te; t += 8) {
      float part = 0.f;
      for (int s = lane; s < t; s += 32) {
        part = fmaf(wdd[t * QS + s] * mt[(t - t0) * QS + s], dts[s], part);
      }
      part = warp_sum(part);
      if (lane == 0) dL[t] += part;
    }
    if (tid < q) {
      if (tid >= t0 && tid < te) diag = wdd[tid * QS + tid] * mt[(tid - t0) * QS + tid];
      for (int t = max(t0, tid + 1); t < te; ++t) {
        colg = fmaf(wdd[t * QS + tid], mt[(t - t0) * QS + tid], colg);
      }
    }
    __syncthreads();
    for (int i = tid; i < (te - t0) * q; i += THREADS) {
      const int r = i / q, s = i - r * q, t = t0 + r;
      mt[r * QS + s] = s <= t ? mt[r * QS + s] * expf(Ls[t] - Ls[s]) * dts[s] : 0.f;
    }
    __syncthreads();
    for (int t = t0; t < te; ++t) {
      const float dv0 = dyT[min(lane, p - 1) * QS + t];
      const float dv1 = dyT[min(lane + 32, p - 1) * QS + t];
      const float* mr = mt + (t - t0) * QS;
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int s = warp + 8 * k;
        if (s <= t) {
          const float mv = mr[s];
          dxa[k][0] = fmaf(mv, dv0, dxa[k][0]);
          dxa[k][1] = fmaf(mv, dv1, dxa[k][1]);
        }
      }
    }
    __syncthreads();  // the next tile rewrites mt
  }

  // (c) Column tiles of B, C, S_in and dS_out.
  const float* Sin = states + (head * nc + c) * p * n;
  const float* dSo = dstates + (head * nc + c) * p * n;
  float ua[KR][2];  // u_s[j] = sum_k dS_out[j][k] B_s[k]
#pragma unroll
  for (int k = 0; k < KR; ++k) ua[k][0] = ua[k][1] = 0.f;
  float ss = 0.f;  // this thread's part of <dS_out, S_in>
  for (int n0 = 0; n0 < n; n0 += NTW) {
    for (int i = tid; i < q * NTW; i += THREADS) {
      const int s = i / NTW, cc = i - s * NTW, k = n0 + cc;
      const size_t src = ((row0 + s) * g + gi) * n + k;
      bt[s * NTS + cc] = k < n ? to_f32<T>(B[src]) : 0.f;
      ct[s * NTS + cc] = k < n ? to_f32<T>(C[src]) : 0.f;
    }
    for (int i = tid; i < p * NTW; i += THREADS) {
      const int j = i / NTW, cc = i - j * NTW, k = n0 + cc;
      const float sv = k < n ? Sin[j * n + k] : 0.f;
      const float dv = k < n ? dSo[j * n + k] : 0.f;
      sn[j * NTS + cc] = sv;
      dn[j * NTS + cc] = dv;
      ss = fmaf(dv, sv, ss);
    }
    __syncthreads();
    // u_s[j] += sum_cc dS_out[j][cc] B_s[cc]
    for (int cc = 0; cc < NTW; ++cc) {
      const float dv0 = dn[min(lane, p - 1) * NTS + cc];
      const float dv1 = dn[min(lane + 32, p - 1) * NTS + cc];
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int s = warp + 8 * k;
        if (s < q) {
          const float bv = bt[s * NTS + cc];
          ua[k][0] = fmaf(dv0, bv, ua[k][0]);
          ua[k][1] = fmaf(dv1, bv, ua[k][1]);
        }
      }
    }
    // dC_t = sum_{s <= t} wdd[t][s] dt_s B_s + exp(L_t) S_in^T dy_t, and
    // dL_t += C_t . (exp(L_t) S_in^T dy_t); lane = column.
    {
      float ca[KR], ci[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k) ca[k] = ci[k] = 0.f;
      for (int s = 0; s < q; ++s) {
        const float bv = bt[s * NTS + lane] * dts[s];
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          const int t = warp + 8 * k;
          if (t < q && s <= t) ca[k] = fmaf(wdd[t * QS + s], bv, ca[k]);
        }
      }
      for (int j = 0; j < p; ++j) {
        const float sv = sn[j * NTS + lane];
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          const int t = warp + 8 * k;
          if (t < q) ci[k] = fmaf(dyT[j * QS + t], sv, ci[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int t = warp + 8 * k;
        if (t < q) {
          const float inter = eL[t] * ci[k];
          if (n0 + lane < n) dCp[((row0 + t) * h + hh) * n + n0 + lane] = ca[k] + inter;
          const float part = warp_sum(ct[t * NTS + lane] * inter);
          if (lane == 0) dL[t] += part;
        }
      }
    }
    // dB_s = dt_s (sum_{t >= s} wdd[t][s] C_t + exp(L_q - L_s) dS_out^T x_s).
    {
      float ba[KR], bs[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k) ba[k] = bs[k] = 0.f;
      for (int t = 0; t < q; ++t) {
        const float cv = ct[t * NTS + lane];
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          const int s = warp + 8 * k;
          if (s <= t) ba[k] = fmaf(wdd[t * QS + s], cv, ba[k]);
        }
      }
      for (int j = 0; j < p; ++j) {
        const float dv = dn[j * NTS + lane];
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          const int s = warp + 8 * k;
          if (s < q) bs[k] = fmaf(xT[j * QS + s], dv, bs[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int s = warp + 8 * k;
        if (s < q && n0 + lane < n) {
          dBp[((row0 + s) * h + hh) * n + n0 + lane] = dts[s] * fmaf(rq[s], bs[k], ba[k]);
        }
      }
    }
    __syncthreads();  // the next tile rewrites bt, ct, sn, dn
  }

  // (d) dx = intra + w_s u_s; r_s; then dL, its reverse cumsum, ddt, dA.
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int s = warp + 8 * k;
    if (s < q) {
      const float ws = rq[s] * dts[s];
      float part = 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int j = lane + 32 * m;
        if (j < p) {
          dx[((row0 + s) * h + hh) * p + j] = from_f32<T>(fmaf(ws, ua[k][m], dxa[k][m]));
          part = fmaf(xT[j * QS + s], ua[k][m], part);
        }
      }
      part = warp_sum(part);
      if (lane == 0) {
        rs[s] = rq[s] * part;
        if (s < q - 1) dL[s] -= dts[s] * rs[s];  // cancels at q - 1
      }
    }
  }
  red[tid] = ss;
  __syncthreads();
  if (tid < q) dL[tid] -= dts[tid] * colg;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int i = 0; i < THREADS; ++i) tot += red[i];
    float sr = 0.f;
    for (int s = 0; s < q - 1; ++s) sr = fmaf(dts[s], rs[s], sr);
    dL[q - 1] += expf(LQ) * tot + sr;
    float rev = 0.f, da = 0.f;
    for (int s = q - 1; s >= 0; --s) {
      rev += dL[s];
      dL[s] = rev;
      da = fmaf(dts[s], rev, da);
    }
    dAp[head * nc + c] = da;
  }
  __syncthreads();
  if (tid < q) ddt[(row0 + tid) * h + hh] = (colg + diag) + rs[tid] + a_h * dL[tid];
}

// 4. dB, dC (b, l, g, n) in T: each group's heads summed in head order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_group_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                     T* __restrict__ dB, T* __restrict__ dC, size_t total, int h, int g,
                     int n) {
  const int rep = h / g;
  for (size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * THREADS) {
    const int k = static_cast<int>(i % n);
    const size_t rest = i / n;
    const int gi = static_cast<int>(rest % g);
    const size_t src = ((rest / g) * h + static_cast<size_t>(gi) * rep) * n + k;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += dBp[src + static_cast<size_t>(r) * n];
      sc += dCp[src + static_cast<size_t>(r) * n];
    }
    dB[i] = from_f32<T>(sb);
    dC[i] = from_f32<T>(sc);
  }
}

// 5. dA (h,) f32: each head's parts summed over batch, then chunks, in order.
__global__ void ssd_bwd_da_kernel(const float* __restrict__ dAp, float* __restrict__ dA, int b,
                                  int h, int nc) {
  const int hh = blockIdx.x * blockDim.x + threadIdx.x;
  if (hh >= h) return;
  float s = 0.f;
  for (int bi = 0; bi < b; ++bi) {
    for (int c = 0; c < nc; ++c) s += dAp[(static_cast<size_t>(bi) * h + hh) * nc + c];
  }
  dA[hh] = s;
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B, const void* C,
                   const void* dy, const float* dstate, void* dx, float* ddt, float* dA,
                   void* dB, void* dC, float* scratch, int b, int l, int h, int p, int g, int n,
                   int q, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_bwd_cb_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_LIMIT));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ssd_bwd_state_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_LIMIT));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_LIMIT));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int nc = l / q;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(B);
  const T* ctp = static_cast<const T*>(C);
  const T* dyt = static_cast<const T*>(dy);
  float* Gs = scratch;
  float* st = Gs + static_cast<size_t>(b) * g * nc * q * q;
  float* dst = st + static_cast<size_t>(b) * h * nc * p * n;
  float* dBp = dst + static_cast<size_t>(b) * h * nc * p * n;
  float* dCp = dBp + static_cast<size_t>(b) * l * h * n;
  float* dAp = dCp + static_cast<size_t>(b) * l * h * n;
  ssd_bwd_cb_kernel<T><<<dim3(nc, g, b), THREADS, cb_smem_floats(q, n) * sizeof(float),
                         stream>>>(bt, ctp, Gs, l, g, n, q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_state_kernel<T><<<dim3(h, b, (p + PT - 1) / PT), THREADS,
                            state_smem_floats(q, n) * sizeof(float), stream>>>(
      xt, dt, A, bt, ctp, dyt, dstate, st, dst, l, h, p, g, n, q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_chunk_kernel<T><<<dim3(nc, h, b), THREADS, chunk_smem_floats(q, p) * sizeof(float),
                            stream>>>(xt, dt, A, bt, ctp, dyt, Gs, st, dst, static_cast<T*>(dx),
                                      ddt, dBp, dCp, dAp, l, h, p, g, n, q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t total = static_cast<size_t>(b) * l * g * n;
  const unsigned blocks = static_cast<unsigned>(
      total / THREADS + 1 < 132 * 8 ? total / THREADS + 1 : 132 * 8);
  ssd_bwd_group_kernel<T><<<blocks, THREADS, 0, stream>>>(
      dBp, dCp, static_cast<T*>(dB), static_cast<T*>(dC), total, h, g, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_da_kernel<<<(h + 127) / 128, 128, 0, stream>>>(dAp, dA, b, h, nc);
  return cudaGetLastError();
}

}  // namespace bwd


// --------------------------------------------------------------------------
// K4b on the tensor cores: the backward for bf16 at the models' shapes (p =
// 64, n in {64, 128}, chunk 64 or 128), the route kernels/ssd_scan/ops.py::
// kernel_for_bwd names "tc".  The plain-FMA kernels above stay the route for
// f32 and every other shape.
//
// Replaces no Pallas kernel, as the plain-FMA route: the TPU package
// differentiates src/repro/kernels/ssd_scan/ref.py:60 (ssd_chunked) with
// jax.grad.  The formulas are ssd_bwd_ref's (above).  Bound at mamba2-1.3b's
// training shape (1 x 4096, 64 heads of 64, state 128, chunk 128): 34.5
// GFLOP, 0.035 ms at the bf16 tensor-core rate.  The plain-FMA kernels take
// 13.7 ms there: one 203 KB block of 8 warps per SM, about one shared load
// per f32 FMA, a serial state sweep, and 268 MB of per-head dB and dC.
//
// Six launches, every sum in a fixed order and nothing atomic, so two calls
// give the same bits:
//
//   (a) ssd_bwd_tc_local_kernel, one block per (head, chunk, batch): each
//       chunk's own contribution to the state, X = (w x)^T B with w_s =
//       exp(L_q - L_s) dt_s, and to its cotangent, Y = (exp(L_t) dy)^T C:
//       one P x n wgmma product per warpgroup (both operands MN-major, the
//       forward's state update), w x and exp(L) dy rounded once to bf16 in
//       place of the TMA-loaded x and dy.  It also writes L = cumsum(dt A)
//       per (head, step), which (b)-(d) read instead of summing again.
//   (b) ssd_bwd_tc_state_kernel: the cross-chunk recurrences, S_in[c+1] =
//       exp(L_q[c]) S_in[c] + X[c] forward and dS_out[c-1] = exp(L_q[c])
//       dS_out[c] + Y[c] backward from the final state's cotangent, in f32,
//       elementwise over (batch, head, P, n), serial only over the chunks
//       (the plain-FMA route's sweep ran q x 16 x n FMAs per chunk there).
//       S_in and dS_out go out in bf16, the layout (c) and (d) load by TMA,
//       with <dS_out, S_in> per (batch, head, chunk) in fixed-order parts.
//   (c) ssd_bwd_tc_chunk_kernel, one block per (chunk, up to HPB heads of
//       one group, batch), q / 64 warpgroups, warpgroup w taking the rows s
//       in [64 w, 64 w + 64).  C B^T is computed once per block (kept as
//       f32 fragments in shared memory) for its heads, which it walks in
//       head order with TMA loads of the next head's tiles in flight:
//         u = B dS_out^T and v = C S_in^T (q x p, K = n; the forward's C S^T
//         shape) give r_s = exp(L_q - L_s) x_s . u_s, w_s u_s (the start of
//         dx) and C_t . (exp(L_t) S_in^T dy_t) = exp(L_t) dy_t . v_t;
//         dot^T = x dy^T (q x q, K = p) with rows s, so that M^T = G D dt_s
//         is rounded to bf16 in place in wgmma's A-register layout (as the
//         forward's M) for dx += M^T dy; the decays above the diagonal are
//         selected to 0 before the exp.  W = dot G D dt_s gives its row
//         sums (in registers) and column sums (shuffles, then shared memory,
//         summed over warps in order) from the f32 accumulators, leaving out
//         the terms that cancel (ssd_bwd_ref); one warp forms dL, its reverse
//         cumsum, ddt and the head's part of dA.  Wd^T = dot D dt_s is
//         summed over the block's heads in f32 registers: since the heads of
//         a group share B and C, dB and dC's chunk-local parts are
//         (sum_h Wd_h)^T C and (sum_h Wd_h) B, one product per block.
//   (d) ssd_bwd_tc_dbdc_kernel, the same blocks: dB = (sum Wd)^T C + sum_h
//       (w x)_h dS_out_h and dC = (sum Wd) B + sum_h (exp(L) dy)_h S_in_h,
//       each 64 x n accumulator in registers across the block's heads (the
//       head sums are the K loop of one product), the bf16 sum of Wd from a
//       swizzled tile read both K-major (dB) and MN-major (dC), w x and
//       exp(L) dy scaled and rounded in registers as wgmma's A operand.
//       Head j + 2's tiles load while head j computes (two buffers, the
//       second over the tiles the first products are done with).
//   (e) bwd::ssd_bwd_group_kernel sums (d)'s per-block parts over a group's
//       blocks in order and casts dB and dC, as it sums the plain-FMA
//       route's per-head parts; (f) bwd::ssd_bwd_da_kernel sums dA.  The
//       per-block parts are 1 / HPB of the per-head dB and dC the plain-FMA
//       route writes, and share their scratch with X and Y.
//
// Rounding: bf16 at w x, exp(L) dy, S_in, dS_out, M^T, the summed Wd and
// the outputs; f32 everywhere else.  tests/test_torch_ssd_bwd.py emulates it
// on the CPU (one rounding of w x is within the backward's 2e-2, where the
// forward's 3e-4 on the state needed a hi/lo split).
//
// Measured (chip_smoke.py phase 18, H100 80GB HBM3 at 700 W) at mamba2-1.3b's
// training shape: 0.441 ms a call against the plain-FMA route's 13.702 in
// the same run (31x), 0.079 of the 0.0349 ms bound, 78 TFLOP/s: the chunk
// kernel ~0.17 ms, the local states, the recurrences and dB/dC ~0.08 ms
// each (the local states and the recurrences move ~0.20 and ~0.24 GB, at
// ~0.75 of the HBM rate).  Each gradient within 5.3e-3 of the plain
// version's largest entry.  ptxas: the chunk kernel 255 registers with 12
// bytes of spill (its f32 sum of Wd^T, the scores and M^T's bf16 registers
// are live together), dB/dC 174, the local states 90, the recurrences 32;
// shared memory 184 / 161 / 98 KB at n = 128 (ops.py::tc_bwd_smem_bytes).

namespace bwd_tc {

using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::P;
using tc::pack_bf16;
using tc::pin_all;
using tc::S_BOX;
using tc::smem_u32;
using tc::SW_ROWS8;
using tc::sw128_desc;
using tc::tma_load_4d;
using tc::wg_commit;
using tc::wg_fence;
using tc::wg_wait_all;
using tc::wgmma_rs_n64_tb;
using tc::wgmma_ss_n64;
using tc::wgmma_state;

constexpr int HPB = 8;       // heads per block of kernels (c) and (d)
constexpr int SPLIT = 1024;  // state entries per block of kernel (b)

// D (64 x 128, f32) += A (64 x 16) . B (16 x 128), both bf16 from shared
// memory; TA / TB = 1 reads that operand MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128, bf16
// from shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
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

// D (64 x N) += A . B, N in {64, 128}: both operands from shared memory, or
// A from registers and B MN-major.
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128) {
    wgmma_ss_n128<TA, TB>(d, da, db);
  } else {
    wgmma_ss_n64<TA, TB>(d, da, db);
  }
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) {
    wgmma_rs_n128_tb(d, a, db);
  } else {
    wgmma_rs_n64_tb(d, a, db);
  }
}

// The two bf16 of a 128B-swizzled tile (rows of 128 bytes: 64 columns) at
// (row, col) and (row, col + 1), col even, as floats.
__device__ __forceinline__ float2 ld_pair(const unsigned char* tile, int row, int col) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
      tile + row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  mbar_init(bar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__host__ __device__ constexpr int ranges(int hpg) { return (hpg + HPB - 1) / HPB; }

// Scratch in floats (kernels/ssd_scan/ops.py::tc_bwd_scratch_floats mirrors
// it): S_in and dS_out in bf16; X and Y in f32, whose room (c) and (d) then
// reuse for the summed Wd^T and the per-block dB and dC; L; the parts of
// <dS_out, S_in>; the (batch, head, chunk) parts of dA.
__host__ __device__ constexpr size_t scratch_floats(int b, int l, int h, int g, int n, int q) {
  return static_cast<size_t>(b) * h * (l / q) * P * n +
         (2 * static_cast<size_t>(b) * h * (l / q) * P * n >
                  static_cast<size_t>(b) * (l / q) * g * ranges(h / g) *
                      (static_cast<size_t>(q) * q + 2 * static_cast<size_t>(q) * n)
              ? 2 * static_cast<size_t>(b) * h * (l / q) * P * n
              : static_cast<size_t>(b) * (l / q) * g * ranges(h / g) *
                    (static_cast<size_t>(q) * q + 2 * static_cast<size_t>(q) * n)) +
         static_cast<size_t>(b) * h * l +
         static_cast<size_t>(b) * h * (l / q) * (P * n / SPLIT) +
         static_cast<size_t>(b) * h * (l / q);
}

// (a) ------------------------------------------------------------------------

template <int N, int Q>
struct LocalLayout {
  static constexpr int nb = N / 64;
  static constexpr uint32_t box = Q * 128;  // Q rows x 64 bf16 columns
  static constexpr uint32_t b_off = 0;
  static constexpr uint32_t c_off = b_off + nb * box;
  static constexpr uint32_t x_off = c_off + nb * box;
  static constexpr uint32_t dy_off = x_off + box;
  static constexpr uint32_t f_off = dy_off + box;  // dt, L: [2][Q] f32
  static constexpr uint32_t bar_off = f_off + 2 * Q * 4;
  static constexpr size_t smem = bar_off + 8 + 1024;
};

// Warpgroup 0 writes X = (w x)^T B, warpgroup 1 Y = (exp(L) dy)^T C, each
// P x N f32 at (batch, head, chunk); one thread per step writes L.
template <int N, int Q>
__global__ void __launch_bounds__(256, 1)
ssd_bwd_tc_local_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap dy_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const __grid_constant__ CUtensorMap c_map, const float* __restrict__ dt,
                        const float* __restrict__ A, float* __restrict__ Lg,
                        float* __restrict__ X, float* __restrict__ Y, int l, int h, int hpg) {
  using LY = LocalLayout<N, Q>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar = base + LY::bar_off;
  float* dts = reinterpret_cast<float*>(smem + LY::f_off);
  float* Ls = dts + Q;
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int hh = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int gi = hh / hpg, nc = l / Q;
  const size_t row0 = static_cast<size_t>(bi) * l + static_cast<size_t>(c) * Q;
  const CUtensorMap *xm = &x_map, *dym = &dy_map, *bm = &b_map, *cm = &c_map;

  if (tid == 0) bar_init(bar);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * LY::nb * LY::box + 2 * LY::box);
#pragma unroll
    for (int x = 0; x < LY::nb; ++x) {
      tma_load_4d(base + LY::b_off + x * LY::box, bm, bar, 64 * x, gi, c * Q, bi);
      tma_load_4d(base + LY::c_off + x * LY::box, cm, bar, 64 * x, gi, c * Q, bi);
    }
    tma_load_4d(base + LY::x_off, xm, bar, 0, hh, c * Q, bi);
    tma_load_4d(base + LY::dy_off, dym, bar, 0, hh, c * Q, bi);
  }
  for (int i = tid; i < Q; i += 256) dts[i] = dt[(row0 + i) * h + hh];
  __syncthreads();
  if (warp == 0) bwd::chunk_cumsum(dts, Ls, A[hh], Q, lane);
  __syncthreads();
  float* Lo = Lg + (static_cast<size_t>(bi) * h + hh) * l + static_cast<size_t>(c) * Q;
  for (int i = tid; i < Q; i += 256) Lo[i] = Ls[i];
  mbar_wait(bar, 0);

  // w_s x_s over x and exp(L_t) dy_t over dy, in place, rounded once: each
  // 16-byte chunk of a swizzled tile lies in one row (chunk k in row k / 8).
  const float LQ = Ls[Q - 1];
  for (int k = tid; k < 2 * Q * 8; k += 256) {
    const int which = k / (Q * 8), kk = k - which * Q * 8, row = kk >> 3;
    const float f = which == 0 ? expf(LQ - Ls[row]) * dts[row] : expf(Ls[row]);
    uint4* ptr = reinterpret_cast<uint4*>(smem + (which == 0 ? LY::x_off : LY::dy_off)) + kk;
    uint4 v = *ptr;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fv = __bfloat1622float2(e[j]);
      e[j] = __floats2bfloat162_rn(fv.x * f, fv.y * f);
    }
    *ptr = v;
  }
  fence_async();
  __syncthreads();

  const uint32_t a_s = base + (wg == 0 ? LY::x_off : LY::dy_off);
  const uint32_t b_s = base + (wg == 0 ? LY::b_off : LY::c_off);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  pin_all(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk) {
    wgmma_state<N>(acc, sw128_desc(a_s + kk * 2048, LY::box, SW_ROWS8),
                   sw128_desc(b_s + kk * 2048, LY::box, SW_ROWS8));
  }
  wg_commit();
  wg_wait_all();
  pin_all(acc);
  float* out = (wg == 0 ? X : Y) + ((static_cast<size_t>(bi) * h + hh) * nc + c) * P * N;
  const int r0 = (warp & 3) * 16 + (lane >> 2), c2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int p = r0 + 8 * ((i >> 1) & 1);
    const int k = 8 * (i >> 2) + c2;
    *reinterpret_cast<float2*>(out + p * N + k) = make_float2(acc[i], acc[i + 1]);
  }
}

// (b) ------------------------------------------------------------------------

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, const float (&v)[4]) {
  uint2 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Block (part, batch x head): state entries [SPLIT part, SPLIT part + SPLIT)
// of one (batch, head), four per thread.  dstate (b, h, P, N) may be null.
template <int N>
__global__ void __launch_bounds__(256)
ssd_bwd_tc_state_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                        const float* __restrict__ Lg, const float* __restrict__ dstate,
                        __nv_bfloat16* __restrict__ s_in, __nv_bfloat16* __restrict__ dso,
                        float* __restrict__ ssp, int l, int q) {
  constexpr int PN = P * N, NPART = PN / SPLIT;
  __shared__ float red[8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, part = blockIdx.x;
  const size_t bh = blockIdx.y;
  const int nc = l / q, e0 = part * SPLIT + tid * 4;
  const float* Lh = Lg + bh * l;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nc; ++c) {
    const size_t o = (bh * nc + c) * PN + e0;
    store_bf16x4(s_in + o, s);
    const float eq = expf(Lh[static_cast<size_t>(c) * q + q - 1]);
    const float4 xv = *reinterpret_cast<const float4*>(X + o);
    s[0] = fmaf(eq, s[0], xv.x);
    s[1] = fmaf(eq, s[1], xv.y);
    s[2] = fmaf(eq, s[2], xv.z);
    s[3] = fmaf(eq, s[3], xv.w);
  }
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  if (dstate != nullptr) {
    const float4 v = *reinterpret_cast<const float4*>(dstate + bh * PN + e0);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const size_t o = (bh * nc + c) * PN + e0;
    store_bf16x4(dso + o, d);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_in + o));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_in + o + 2));
    float dot = d[0] * a.x;
    dot = fmaf(d[1], a.y, dot);
    dot = fmaf(d[2], b.x, dot);
    dot = fmaf(d[3], b.y, dot);
    dot = bwd::warp_sum(dot);
    if (lane == 0) red[warp] = dot;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < 8; ++w) t += red[w];
      ssp[(bh * nc + c) * NPART + part] = t;
    }
    __syncthreads();
    const float eq = expf(Lh[static_cast<size_t>(c) * q + q - 1]);
    const float4 yv = *reinterpret_cast<const float4*>(Y + o);
    d[0] = fmaf(eq, d[0], yv.x);
    d[1] = fmaf(eq, d[1], yv.y);
    d[2] = fmaf(eq, d[2], yv.z);
    d[3] = fmaf(eq, d[3], yv.w);
  }
}

// (c) ------------------------------------------------------------------------

template <int N, int Q>
struct ChunkLayout {
  static constexpr int NW = Q / 64;  // warpgroups
  static constexpr int THR = NW * 128;
  static constexpr int nb = N / 64;
  static constexpr uint32_t box = Q * 128;
  static constexpr int gtiles = NW * (NW + 1) / 2;  // 64 x 64 tiles of G^T on or above the diagonal
  static constexpr uint32_t b_off = 0;
  static constexpr uint32_t c_off = b_off + nb * box;
  static constexpr uint32_t x_off = c_off + nb * box;
  static constexpr uint32_t dy_off = x_off + box;
  static constexpr uint32_t si_off = dy_off + box;
  static constexpr uint32_t so_off = si_off + nb * S_BOX;
  static constexpr uint32_t g_off = so_off + nb * S_BOX;       // G^T fragments, f32
  static constexpr uint32_t f_off = g_off + gtiles * 32 * 128 * 4;
  // dt, L, row sums, diagonal, r, the inter term of dL: [6][Q]; column
  // sums per warp: [4 NW][Q]; all f32.
  static constexpr uint32_t bar_off = f_off + (6 + 4 * NW) * Q * 4;
  static constexpr size_t smem = bar_off + 3 * 8 + 1024;
};

// Sums one value per column over the 8 lanes of a warp that share lane & 3
// (the rows of a wgmma fragment), halving the values each step: cp[v] holds
// column 8 (v >> 1) + c2 + (v & 1); lane ends with columns 8 (lane >> 2) +
// c2 + {0, 1} in out[0], out[1].
__device__ __forceinline__ void column_sums(const float (&cp)[16], int lane, float (&out)[2]) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float h8[8], h4[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float keep = b4 ? cp[8 + k] : cp[k], give = b4 ? cp[k] : cp[8 + k];
    h8[k] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float keep = b3 ? h8[4 + k] : h8[k], give = b3 ? h8[k] : h8[4 + k];
    h4[k] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float keep = b2 ? h4[2 + k] : h4[k], give = b2 ? h4[k] : h4[2 + k];
    out[k] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
  }
}

// Block (group x range, chunk, batch): heads [h0, h0 + nh) of group gi.
// Writes dx and ddt, each head's part of dA per chunk, and the block's
// sum of Wd^T over its heads (Q x Q f32, zero below the diagonal).
template <int N, int Q>
__global__ void __launch_bounds__(ChunkLayout<N, Q>::THR, 1)
ssd_bwd_tc_chunk_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap dy_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const __grid_constant__ CUtensorMap c_map,
                        const __grid_constant__ CUtensorMap si_map,
                        const __grid_constant__ CUtensorMap so_map, const float* __restrict__ dt,
                        const float* __restrict__ A, const float* __restrict__ Lg,
                        const float* __restrict__ ssp, __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ dAp,
                        float* __restrict__ wdp, int l, int h, int hpg, int R) {
  using LY = ChunkLayout<N, Q>;
  constexpr int NW = LY::NW, NPART = P * N / SPLIT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t b_s = base + LY::b_off, c_s = base + LY::c_off, x_s = base + LY::x_off,
                 dy_s = base + LY::dy_off, si_s = base + LY::si_off, so_s = base + LY::so_off;
  const unsigned char* xt = smem + LY::x_off;
  const unsigned char* dyt = smem + LY::dy_off;
  float4* gfr = reinterpret_cast<float4*>(smem + LY::g_off);
  float* dts = reinterpret_cast<float*>(smem + LY::f_off);
  float* Ls = dts + Q;
  float* rowS = Ls + Q;
  float* diag = rowS + Q;
  float* rs = diag + Q;
  float* dli = rs + Q;
  float* colp = dli + Q;
  const uint32_t bar_bc = base + LY::bar_off, bar_xd = bar_bc + 8, bar_st = bar_bc + 16;

  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127, warp = tid >> 5, lane = tid & 31;
  const int gi = blockIdx.x / R, rr = blockIdx.x - gi * R;
  const int h0 = gi * hpg + rr * HPB, nh = min(HPB, hpg - rr * HPB);
  const int c = blockIdx.y, bi = blockIdx.z, nc = l / Q;
  const size_t row0 = static_cast<size_t>(bi) * l + static_cast<size_t>(c) * Q;
  // Accumulator fragment of wgmma m64nN: rows r0 and r0 + 8 of the
  // warpgroup's 64; element i in row r0 + 8 ((i >> 1) & 1), column 8 (i >>
  // 2) + c2 + (i & 1).
  const int r0 = (warp & 3) * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  const int s0 = wg * 64 + r0, s1 = s0 + 8;

  const CUtensorMap *xm = &x_map, *dym = &dy_map, *sim = &si_map, *som = &so_map;
  auto issue_xd = [=](int j) {
    mbar_expect_tx(bar_xd, 2 * LY::box);
    tma_load_4d(x_s, xm, bar_xd, 0, h0 + j, c * Q, bi);
    tma_load_4d(dy_s, dym, bar_xd, 0, h0 + j, c * Q, bi);
  };
  auto issue_st = [=](int j) {
    const int idx = (bi * h + h0 + j) * nc + c;
    mbar_expect_tx(bar_st, 2 * LY::nb * S_BOX);
#pragma unroll
    for (int x = 0; x < LY::nb; ++x) {
      tma_load_4d(si_s + x * S_BOX, sim, bar_st, 64 * x, 0, 0, idx);
      tma_load_4d(so_s + x * S_BOX, som, bar_st, 64 * x, 0, 0, idx);
    }
  };
  if (tid == 0) {
    bar_init(bar_bc);
    bar_init(bar_xd);
    bar_init(bar_st);
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_bc, 2 * LY::nb * LY::box);
#pragma unroll
    for (int x = 0; x < LY::nb; ++x) {
      tma_load_4d(b_s + x * LY::box, &b_map, bar_bc, 64 * x, gi, c * Q, bi);
      tma_load_4d(c_s + x * LY::box, &c_map, bar_bc, 64 * x, gi, c * Q, bi);
    }
    issue_st(0);
    issue_xd(0);
  }
  mbar_wait(bar_bc, 0);

  // G^T = B C^T for rows s of this warpgroup and columns t >= 64 wg, kept as
  // f32 fragments in shared memory: tile (wg, ct) at index wg NW - wg (wg -
  // 1) / 2 + ct - wg, 32 values per thread in float4 groups.
  {
    float g[NW][32];
#pragma unroll
    for (int ct = 0; ct < NW; ++ct) {
#pragma unroll
      for (int i = 0; i < 32; ++i) g[ct][i] = 0.f;
      pin_all(g[ct]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t koff = (kk >> 2) * LY::box + (kk & 3) * 32;
      const uint64_t da = sw128_desc(b_s + koff + wg * 64 * 128, 16, SW_ROWS8);
#pragma unroll
      for (int ct = 0; ct < NW; ++ct) {
        if (ct >= wg)
          wgmma_ss_n64<0, 0>(g[ct], da, sw128_desc(c_s + koff + ct * 64 * 128, 16, SW_ROWS8));
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int ct = 0; ct < NW; ++ct) {
      pin_all(g[ct]);
      if (ct >= wg) {
        float4* dst = gfr + (wg * NW - wg * (wg - 1) / 2 + ct - wg) * 1024;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          dst[k * 128 + lt] = make_float4(g[ct][4 * k], g[ct][4 * k + 1], g[ct][4 * k + 2],
                                          g[ct][4 * k + 3]);
      }
    }
  }

  float wd[NW][32];  // sum over the block's heads of Wd^T, rows s
#pragma unroll
  for (int ct = 0; ct < NW; ++ct) {
#pragma unroll
    for (int i = 0; i < 32; ++i) wd[ct][i] = 0.f;
  }

  for (int j = 0; j < nh; ++j) {
    const int head = h0 + j;
    const uint32_t ph = j & 1;
    const float* Lh = Lg + (static_cast<size_t>(bi) * h + head) * l + static_cast<size_t>(c) * Q;
    for (int i = tid; i < Q; i += LY::THR) {
      dts[i] = dt[(row0 + i) * h + head];
      Ls[i] = Lh[i];
    }
    __syncthreads();
    const float LQ = Ls[Q - 1];
    const float L0 = Ls[s0], L1 = Ls[s1], dt0 = dts[s0], dt1 = dts[s1];
    const float rq0 = expf(LQ - L0), rq1 = expf(LQ - L1);
    mbar_wait(bar_st, ph);
    mbar_wait(bar_xd, ph);

    // u = B dS_out^T and v = C S_in^T (rows 64 wg.., P columns, K = N).
    float ua[32], va[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) ua[i] = va[i] = 0.f;
    pin_all(ua);
    pin_all(va);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t koff = (kk >> 2) * LY::box + (kk & 3) * 32 + wg * 64 * 128;
      const uint32_t soff = (kk >> 2) * S_BOX + (kk & 3) * 32;
      wgmma_ss_n64<0, 0>(ua, sw128_desc(b_s + koff, 16, SW_ROWS8),
                         sw128_desc(so_s + soff, 16, SW_ROWS8));
      wgmma_ss_n64<0, 0>(va, sw128_desc(c_s + koff, 16, SW_ROWS8),
                         sw128_desc(si_s + soff, 16, SW_ROWS8));
    }
    wg_commit();
    wg_wait_all();
    pin_all(ua);
    pin_all(va);
    // r_s = exp(L_q - L_s) x_s . u_s; the inter term of dL_t, exp(L_t) dy_t . v_t.
    float px0 = 0.f, px1 = 0.f, pd0 = 0.f, pd1 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = 8 * k + c2;
      const float2 xa = ld_pair(xt, s0, col), xb = ld_pair(xt, s1, col);
      const float2 da = ld_pair(dyt, s0, col), db = ld_pair(dyt, s1, col);
      px0 = fmaf(xa.y, ua[4 * k + 1], fmaf(xa.x, ua[4 * k], px0));
      px1 = fmaf(xb.y, ua[4 * k + 3], fmaf(xb.x, ua[4 * k + 2], px1));
      pd0 = fmaf(da.y, va[4 * k + 1], fmaf(da.x, va[4 * k], pd0));
      pd1 = fmaf(db.y, va[4 * k + 3], fmaf(db.x, va[4 * k + 2], pd1));
    }
    px0 = quad_sum(px0);
    px1 = quad_sum(px1);
    pd0 = quad_sum(pd0);
    pd1 = quad_sum(pd1);
    if ((lane & 3) == 0) {
      rs[s0] = rq0 * px0;
      rs[s1] = rq1 * px1;
      dli[s0] = expf(L0) * pd0;
      dli[s1] = expf(L1) * pd1;
    }
    // dx starts as w_s u_s.
    const float w0 = rq0 * dt0, w1 = rq1 * dt1;
#pragma unroll
    for (int i = 0; i < 32; ++i) ua[i] *= (i & 2) ? w1 : w0;
    __syncthreads();  // every wgmma is done with S_in and dS_out
    if (tid == 0 && j + 1 < nh) issue_st(j + 1);

    // dot^T = x dy^T: rows s, columns t >= 64 wg, K = P.
    float sc[NW][32];
#pragma unroll
    for (int ct = 0; ct < NW; ++ct) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[ct][i] = 0.f;
      pin_all(sc[ct]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      const uint64_t da = sw128_desc(x_s + wg * 64 * 128 + kk * 32, 16, SW_ROWS8);
#pragma unroll
      for (int ct = 0; ct < NW; ++ct) {
        if (ct >= wg)
          wgmma_ss_n64<0, 0>(sc[ct], da, sw128_desc(dy_s + ct * 64 * 128 + kk * 32, 16, SW_ROWS8));
      }
    }
    wg_commit();
    wg_wait_all();

    // Per entry (s, t >= s): D = exp(L_t - L_s), the exponent selected to
    // -inf above the diagonal before the exp; W = dot G D into the row sums
    // (strict and diagonal apart) and, times dt_s, the strict column sums;
    // Wd^T += dot D dt_s; M^T = G D dt_s rounded to bf16 as A registers of
    // K-step 4 ct + k / 2.
    const float neg_inf = -__int_as_float(0x7f800000);
    uint32_t pa[Q / 16][4];
    float rs0 = 0.f, rs1 = 0.f, dg0 = 0.f, dg1 = 0.f;
#pragma unroll
    for (int ct = 0; ct < NW; ++ct) {
      pin_all(sc[ct]);
      if (ct >= wg) {
        const float4* gt = gfr + (wg * NW - wg * (wg - 1) / 2 + ct - wg) * 1024;
        float cp[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) cp[k] = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 gq = gt[k * 128 + lt];
          const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
          const int tb = 64 * ct + 8 * k + c2;
          const float2 Lt = *reinterpret_cast<const float2*>(Ls + tb);
          float m[4];
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const int i = 4 * k + q4, e = q4 & 1, rw = q4 >> 1;
            const int t = tb + e, s = rw ? s1 : s0;
            const float Lsr = rw ? L1 : L0, dtr = rw ? dt1 : dt0;
            const float D = __expf(t >= s ? (e ? Lt.y : Lt.x) - Lsr : neg_inf);
            const float d = sc[ct][i];
            const float gd = gv[q4] * D;
            const float wv = d * gd;
            if (rw) {
              rs1 += t > s ? wv : 0.f;
              dg1 += t == s ? wv : 0.f;
            } else {
              rs0 += t > s ? wv : 0.f;
              dg0 += t == s ? wv : 0.f;
            }
            cp[2 * k + e] += t > s ? wv * dtr : 0.f;
            wd[ct][i] = fmaf(d * D, dtr, wd[ct][i]);
            m[q4] = gd * dtr;
          }
          pa[4 * ct + (k >> 1)][2 * (k & 1)] = pack_bf16(m[0], m[1]);
          pa[4 * ct + (k >> 1)][2 * (k & 1) + 1] = pack_bf16(m[2], m[3]);
        }
        float cs[2];
        column_sums(cp, lane, cs);
        *reinterpret_cast<float2*>(colp + warp * Q + 64 * ct + 8 * (lane >> 2) + c2) =
            make_float2(cs[0], cs[1]);
      }
    }
    rs0 = quad_sum(rs0);
    rs1 = quad_sum(rs1);
    dg0 = quad_sum(dg0);
    dg1 = quad_sum(dg1);
    if ((lane & 3) == 0) {
      rowS[s0] = rs0;
      rowS[s1] = rs1;
      diag[s0] = dg0;
      diag[s1] = dg1;
    }

    // dx = w_s u_s + M^T dy: dy MN-major (P contiguous), 16 steps t per
    // K-step, from t = 64 wg.
    pin_all(ua);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (kk >= 4 * wg) wgmma_rs_n64_tb(ua, pa[kk], sw128_desc(dy_s + kk * 2048, LY::box, SW_ROWS8));
    }
    wg_commit();
    wg_wait_all();
    pin_all(ua);
    __nv_bfloat16* x0 = dx + ((row0 + s0) * h + head) * P;
    __nv_bfloat16* x1 = dx + ((row0 + s1) * h + head) * P;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      *reinterpret_cast<__nv_bfloat162*>(x0 + 8 * k + c2) =
          __floats2bfloat162_rn(ua[4 * k], ua[4 * k + 1]);
      *reinterpret_cast<__nv_bfloat162*>(x1 + 8 * k + c2) =
          __floats2bfloat162_rn(ua[4 * k + 2], ua[4 * k + 3]);
    }
    fence_async();
    __syncthreads();  // x, dy free; the per-step sums are in shared memory
    if (tid == 0 && j + 1 < nh) issue_xd(j + 1);

    // dL_t = (sum_{s<t} W[t,s]) - dt_t (sum_{t'>t} W[t',t]) + the inter term
    // - dt_t r_t (t < q - 1), and at q - 1 also exp(L_q) <dS_out, S_in> +
    // sum_{s<q-1} dt_s r_s; its reverse cumsum gives ddt and dA.  One warp,
    // each lane Q / 32 consecutive steps, the lanes' runs joined by a
    // shuffle scan: a fixed order.
    if (warp == 0) {
      constexpr int PER = Q / 32;
      float dl[PER], sr = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int t = lane * PER + k;
        float cs = 0.f;
        for (int wq = 0; wq < (t + 15) / 16; ++wq) cs += colp[wq * Q + t];
        float v = cs - dts[t] * rowS[t] + dli[t];
        if (t < Q - 1) {
          const float tr = dts[t] * rs[t];
          v -= tr;
          sr += tr;
        }
        dl[k] = v;
      }
      sr = bwd::warp_sum(sr);
      if (lane == 31) {
        const float* sp = ssp + ((static_cast<size_t>(bi) * h + head) * nc + c) * NPART;
        float ss = 0.f;
#pragma unroll
        for (int k = 0; k < NPART; ++k) ss += sp[k];
        dl[PER - 1] += expf(LQ) * ss + sr;
      }
      float run = 0.f;
#pragma unroll
      for (int k = PER - 1; k >= 0; --k) {
        run += dl[k];
        dl[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.f;
      const float a_h = A[head];
      float da = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int t = lane * PER + k;
        const float rev = dl[k] + after;
        ddt[(row0 + t) * h + head] = (rowS[t] + diag[t]) + rs[t] + a_h * rev;
        da = fmaf(dts[t], rev, da);
      }
      da = bwd::warp_sum(da);
      if (lane == 0) dAp[(static_cast<size_t>(bi) * h + head) * nc + c] = da;
    }
    __syncthreads();  // the next head rewrites the per-step vectors
  }

  float* wo = wdp + ((static_cast<size_t>(bi) * nc + c) * gridDim.x + blockIdx.x) * Q * Q;
#pragma unroll
  for (int ct = 0; ct < NW; ++ct) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int s = (i & 2) ? s1 : s0;
      const int t = 64 * ct + 8 * (i >> 2) + c2;
      *reinterpret_cast<float2*>(wo + s * Q + t) =
          ct >= wg ? make_float2(wd[ct][i], wd[ct][i + 1]) : make_float2(0.f, 0.f);
    }
  }
}

// (d) ------------------------------------------------------------------------

template <int N, int Q>
struct DbdcLayout {
  static constexpr int NW = Q / 64;
  static constexpr int THR = NW * 128;
  static constexpr int nb = N / 64;
  static constexpr uint32_t box = Q * 128;
  // One head's tiles: x, dy (Q x P), S_in, dS_out (P x N), bf16.
  static constexpr uint32_t head = 2 * box + 2 * nb * S_BOX;
  // The summed Wd^T (Q x Q), C and B (Q x N); later head buffer 1.
  static constexpr uint32_t front = NW * box + 2 * nb * box;
  static constexpr uint32_t wd_off = 0;
  static constexpr uint32_t c_off = wd_off + NW * box;
  static constexpr uint32_t b_off = c_off + nb * box;
  static constexpr uint32_t buf0 = front > head ? front : head;  // head buffer 0
  static constexpr uint32_t bar_off = buf0 + head;
  static constexpr size_t smem = bar_off + 3 * 8 + 1024;
};

// Block as (c): dB (rows s) and dC (rows t) of warpgroup wg's 64 rows, over
// the block's heads, into its part of the group's sum (Q x N f32 each).
template <int N, int Q>
__global__ void __launch_bounds__(DbdcLayout<N, Q>::THR, 1)
ssd_bwd_tc_dbdc_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap dy_map,
                       const __grid_constant__ CUtensorMap b_map,
                       const __grid_constant__ CUtensorMap c_map,
                       const __grid_constant__ CUtensorMap si_map,
                       const __grid_constant__ CUtensorMap so_map, const float* __restrict__ dt,
                       const float* __restrict__ Lg, const float* __restrict__ wdp,
                       float* __restrict__ dBp, float* __restrict__ dCp, int l, int h, int hpg,
                       int R) {
  using LY = DbdcLayout<N, Q>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t wd_s = base + LY::wd_off, cc_s = base + LY::c_off, bb_s = base + LY::b_off;
  const uint32_t bar_bc = base + LY::bar_off;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int gi = blockIdx.x / R, rr = blockIdx.x - gi * R;
  const int h0 = gi * hpg + rr * HPB, nh = min(HPB, hpg - rr * HPB);
  const int c = blockIdx.y, bi = blockIdx.z, nc = l / Q;
  const size_t row0 = static_cast<size_t>(bi) * l + static_cast<size_t>(c) * Q;
  const int r0 = (warp & 3) * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  const int s0 = wg * 64 + r0, s1 = s0 + 8;

  const CUtensorMap *xm = &x_map, *dym = &dy_map, *sim = &si_map, *som = &so_map;
  const uint32_t buf0 = base + LY::buf0, bar0 = bar_bc + 8;
  // Head j's tiles in buffer j & 1 (buffer 1 over Wd^T, C and B) on
  // mbarrier j & 1.
  auto issue_head = [=](int j) {
    const uint32_t hb = (j & 1) ? base : buf0, bar = bar0 + 8 * (j & 1);
    const int idx = (bi * h + h0 + j) * nc + c;
    mbar_expect_tx(bar, LY::head);
    tma_load_4d(hb, xm, bar, 0, h0 + j, c * Q, bi);
    tma_load_4d(hb + LY::box, dym, bar, 0, h0 + j, c * Q, bi);
#pragma unroll
    for (int x = 0; x < LY::nb; ++x) {
      tma_load_4d(hb + 2 * LY::box + x * S_BOX, sim, bar, 64 * x, 0, 0, idx);
      tma_load_4d(hb + 2 * LY::box + (LY::nb + x) * S_BOX, som, bar, 64 * x, 0, 0, idx);
    }
  };
  if (tid == 0) {
    bar_init(bar_bc);
    bar_init(bar0);
    bar_init(bar0 + 8);
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_bc, 2 * LY::nb * LY::box);
#pragma unroll
    for (int x = 0; x < LY::nb; ++x) {
      tma_load_4d(cc_s + x * LY::box, &c_map, bar_bc, 64 * x, gi, c * Q, bi);
      tma_load_4d(bb_s + x * LY::box, &b_map, bar_bc, 64 * x, gi, c * Q, bi);
    }
    issue_head(0);
  }
  // The summed Wd^T in bf16, rows s and 64-column boxes of t, swizzled.
  const float* wi = wdp + ((static_cast<size_t>(bi) * nc + c) * gridDim.x + blockIdx.x) * Q * Q;
  for (int e = tid; e < Q * Q / 8; e += LY::THR) {
    const int s = e / (Q / 8), t = (e - s * (Q / 8)) * 8;
    const float4 a = *reinterpret_cast<const float4*>(wi + s * Q + t);
    const float4 b = *reinterpret_cast<const float4*>(wi + s * Q + t + 4);
    uint4 v;
    v.x = pack_bf16(a.x, a.y);
    v.y = pack_bf16(a.z, a.w);
    v.z = pack_bf16(b.x, b.y);
    v.w = pack_bf16(b.z, b.w);
    *reinterpret_cast<uint4*>(smem + LY::wd_off + (t >> 6) * LY::box + s * 128 +
                              ((((t & 63) >> 3) ^ (s & 7)) << 4)) = v;
  }
  fence_async();
  __syncthreads();
  mbar_wait(bar_bc, 0);

  // dB = Wd^T C over t >= 64 wg (A K-major, C MN-major); dC = Wd B over s <
  // 64 wg + 64 (A MN-major from the same tile, B MN-major).
  float dBa[N / 2], dCa[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dBa[i] = dCa[i] = 0.f;
  pin_all(dBa);
  pin_all(dCa);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk) {
    if (kk >= 4 * wg)
      mma_ss<N, 0, 1>(dBa,
                      sw128_desc(wd_s + (kk >> 2) * LY::box + (kk & 3) * 32 + wg * 64 * 128, 16,
                                 SW_ROWS8),
                      sw128_desc(cc_s + kk * 2048, LY::box, SW_ROWS8));
    if (kk < 4 * wg + 4)
      mma_ss<N, 1, 1>(dCa, sw128_desc(wd_s + wg * LY::box + kk * 2048, LY::box, SW_ROWS8),
                      sw128_desc(bb_s + kk * 2048, LY::box, SW_ROWS8));
  }
  wg_commit();
  wg_wait_all();
  pin_all(dBa);
  pin_all(dCa);
  __syncthreads();  // every wgmma is done with Wd^T, B and C
  if (tid == 0 && nh > 1) issue_head(1);

  for (int j = 0; j < nh; ++j) {
    const int head = h0 + j;
    const float* Lh = Lg + (static_cast<size_t>(bi) * h + head) * l + static_cast<size_t>(c) * Q;
    const float LQ = Lh[Q - 1], L0 = Lh[s0], L1 = Lh[s1];
    const float w0 = expf(LQ - L0) * dt[(row0 + s0) * h + head];
    const float w1 = expf(LQ - L1) * dt[(row0 + s1) * h + head];
    const float e0 = expf(L0), e1 = expf(L1);
    const uint32_t hb = (j & 1) ? base : buf0;
    const unsigned char* hp = smem + (hb - base);
    mbar_wait(bar0 + 8 * (j & 1), (j >> 1) & 1);
    // A registers: (w x) for dB and (exp(L) dy) for dC, K = P in 4 steps.
    uint32_t ax[P / 16][4], ad[P / 16][4];
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int row = (q4 & 1) ? s1 : s0, col = 16 * kk + 8 * (q4 >> 1) + c2;
        const float wr = (q4 & 1) ? w1 : w0, er = (q4 & 1) ? e1 : e0;
        const float2 xv = ld_pair(hp, row, col), dv = ld_pair(hp + LY::box, row, col);
        ax[kk][q4] = pack_bf16(xv.x * wr, xv.y * wr);
        ad[kk][q4] = pack_bf16(dv.x * er, dv.y * er);
      }
    }
    pin_all(dBa);
    pin_all(dCa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      mma_rs<N>(dBa, ax[kk],
                sw128_desc(hb + 2 * LY::box + LY::nb * S_BOX + kk * 2048, S_BOX, SW_ROWS8));
      mma_rs<N>(dCa, ad[kk], sw128_desc(hb + 2 * LY::box + kk * 2048, S_BOX, SW_ROWS8));
    }
    wg_commit();
    wg_wait_all();
    pin_all(dBa);
    pin_all(dCa);
    __syncthreads();  // the buffer is free
    if (tid == 0 && j + 2 < nh) issue_head(j + 2);
  }

  // Parts (b, l, g R, N): a group's R parts of a step side by side, in the
  // layout bwd::ssd_bwd_group_kernel sums per-head parts in.
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const size_t row = row0 + wg * 64 + r0 + 8 * ((i >> 1) & 1);
    const size_t o = (row * gridDim.x + blockIdx.x) * N + 8 * (i >> 2) + c2;
    *reinterpret_cast<float2*>(dBp + o) = make_float2(dBa[i], dBa[i + 1]);
    *reinterpret_cast<float2*>(dCp + o) = make_float2(dCa[i], dCa[i + 1]);
  }
}

template <int N, int Q>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B, const void* C,
                   const void* dy, const float* dstate, void* dx, float* ddt, float* dA,
                   void* dB, void* dC, float* scratch, int b, int l, int h, int g,
                   cudaStream_t stream) {
  using LA = LocalLayout<N, Q>;
  using LC = ChunkLayout<N, Q>;
  using LD = DbdcLayout<N, Q>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_bwd_tc_local_kernel<N, Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(LA::smem));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ssd_bwd_tc_chunk_kernel<N, Q>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(LC::smem));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ssd_bwd_tc_dbdc_kernel<N, Q>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(LD::smem));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int nc = l / Q, hpg = h / g, R = ranges(hpg);
  const size_t bhc = static_cast<size_t>(b) * h * nc, pn = static_cast<size_t>(P) * N;
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* dso = s_in + bhc * pn;
  float* work = scratch + bhc * pn;
  const size_t parts = static_cast<size_t>(b) * nc * g * R * (Q * Q + 2 * Q * N);
  float* X = work;
  float* Y = work + bhc * pn;
  float* wdp = work;
  float* dBp = work + static_cast<size_t>(b) * nc * g * R * Q * Q;
  float* dCp = dBp + static_cast<size_t>(b) * nc * g * R * Q * N;
  float* Lg = work + (2 * bhc * pn > parts ? 2 * bhc * pn : parts);
  float* ssp = Lg + static_cast<size_t>(b) * h * l;
  float* dAp = ssp + bhc * (pn / SPLIT);
  CUtensorMap x_map, dy_map, b_map, c_map, si_map, so_map;
  const int bhc_i = static_cast<int>(bhc);
  if (!tc::make_map(encode, &x_map, x, b, l, h, P, Q) ||
      !tc::make_map(encode, &dy_map, dy, b, l, h, P, Q) ||
      !tc::make_map(encode, &b_map, B, b, l, g, N, Q) ||
      !tc::make_map(encode, &c_map, C, b, l, g, N, Q) ||
      !tc::make_map(encode, &si_map, s_in, bhc_i, P, 1, N, 64) ||
      !tc::make_map(encode, &so_map, dso, bhc_i, P, 1, N, 64)) {
    return cudaErrorInvalidValue;
  }
  ssd_bwd_tc_local_kernel<N, Q><<<dim3(h, nc, b), 256, LA::smem, stream>>>(
      x_map, dy_map, b_map, c_map, dt, A, Lg, X, Y, l, h, hpg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_tc_state_kernel<N><<<dim3(static_cast<unsigned>(pn / SPLIT), b * h), 256, 0, stream>>>(
      X, Y, Lg, dstate, s_in, dso, ssp, l, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_tc_chunk_kernel<N, Q><<<dim3(g * R, nc, b), LC::THR, LC::smem, stream>>>(
      x_map, dy_map, b_map, c_map, si_map, so_map, dt, A, Lg, ssp,
      static_cast<__nv_bfloat16*>(dx), ddt, dAp, wdp, l, h, hpg, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_tc_dbdc_kernel<N, Q><<<dim3(g * R, nc, b), LD::THR, LD::smem, stream>>>(
      x_map, dy_map, b_map, c_map, si_map, so_map, dt, Lg, wdp, dBp, dCp, l, h, hpg, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t total = static_cast<size_t>(b) * l * g * N;
  const unsigned blocks = static_cast<unsigned>(
      total / THREADS + 1 < 132 * 8 ? total / THREADS + 1 : 132 * 8);
  bwd::ssd_bwd_group_kernel<__nv_bfloat16><<<blocks, THREADS, 0, stream>>>(
      dBp, dCp, static_cast<__nv_bfloat16*>(dB), static_cast<__nv_bfloat16*>(dC), total, g * R, g,
      N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd::ssd_bwd_da_kernel<<<(h + 127) / 128, 128, 0, stream>>>(dAp, dA, b, h, nc);
  return cudaGetLastError();
}

}  // namespace bwd_tc

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

// The tensor-core kernel: x, B, C bf16 with p = 64, n in {64, 128} and
// chunk in {64, 128}; dt, A f32; y bf16; state f32.  Shapes and layouts as
// ssd_scan_launch, contiguous and 16-byte aligned; l a multiple of chunk.
extern "C" int ssd_scan_tc_launch(const void* x, const void* dt, const void* A,
                                  const void* B, const void* C, void* y,
                                  void* state, int b, int l, int h, int p,
                                  int g, int n, int chunk, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || b > 65535 || l < 1 || h < 1 || g < 1 || h % g != 0 ||
      p != tc::P || chunk < 1 || l % chunk != 0 || ((h / g + 1) / 2) * g > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  if (n == 128 && chunk == 128)
    return static_cast<int>(tc::launch<128, 128>(x, dtf, Af, B, C, y, sf, b, l, h, g, stream));
  if (n == 128 && chunk == 64)
    return static_cast<int>(tc::launch<128, 64>(x, dtf, Af, B, C, y, sf, b, l, h, g, stream));
  if (n == 64 && chunk == 128)
    return static_cast<int>(tc::launch<64, 128>(x, dtf, Af, B, C, y, sf, b, l, h, g, stream));
  if (n == 64 && chunk == 64)
    return static_cast<int>(tc::launch<64, 64>(x, dtf, Af, B, C, y, sf, b, l, h, g, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of ssd_scan_launch (K4b): x, B, C, dy and dx, dB, dC in one
// dtype (0 = float32, 1 = bfloat16); dt, A, ddt, dA f32; dstate (b, h, p,
// n) f32 or null (a zero cotangent).  p <= 64, n <= 128, chunk <= 128, l a
// multiple of chunk, all contiguous.  scratch holds scratch_floats f32,
// which must equal bwd::scratch_floats for these shapes (kernels/ssd_scan/
// ops.py::bwd_scratch_floats), or the call is refused.  Five launches.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* A,
                                   const void* B, const void* C, const void* dy,
                                   const void* dstate, void* dx, void* ddt, void* dA,
                                   void* dB, void* dC, void* scratch,
                                   long long scratch_floats, int dtype, int b, int l,
                                   int h, int p, int g, int n, int chunk,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || b > 65535 || l < 1 || h < 1 || h > 65535 || g < 1 || g > 65535 ||
      h % g != 0 || p < 1 || p > MAX_P || n < 1 || n > MAX_N || chunk < 1 ||
      chunk > MAX_Q || l % chunk != 0 ||
      bwd::chunk_smem_floats(chunk, p) * sizeof(float) > SMEM_LIMIT ||
      static_cast<size_t>(scratch_floats) !=
          bwd::scratch_floats(b, l, h, p, g, n, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* dsf = static_cast<const float*>(dstate);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = bwd::launch<float>(x, dtf, Af, B, C, dy, dsf, dx, static_cast<float*>(ddt),
                             static_cast<float*>(dA), dB, dC, sc, b, l, h, p, g, n, chunk,
                             stream);
  } else if (dtype == 1) {
    err = bwd::launch<__nv_bfloat16>(x, dtf, Af, B, C, dy, dsf, dx, static_cast<float*>(ddt),
                                     static_cast<float*>(dA), dB, dC, sc, b, l, h, p, g, n,
                                     chunk, stream);
  }
  return static_cast<int>(err);
}

// The tensor-core backward (K4b's "tc" route): x, B, C, dy and dx, dB, dC
// bf16 with p = 64, n in {64, 128}, chunk in {64, 128}; dt, A, ddt, dA f32;
// dstate (b, h, p, n) f32 or null (a zero cotangent).  All contiguous, x,
// B, C and dy 16-byte aligned, l a multiple of chunk.  scratch holds
// scratch_floats f32, which must equal bwd_tc::scratch_floats for these
// shapes (kernels/ssd_scan/ops.py::tc_bwd_scratch_floats), or the call is
// refused.  Six launches.
extern "C" int ssd_scan_bwd_tc_launch(const void* x, const void* dt, const void* A,
                                      const void* B, const void* C, const void* dy,
                                      const void* dstate, void* dx, void* ddt, void* dA,
                                      void* dB, void* dC, void* scratch,
                                      long long scratch_floats, int b, int l, int h, int p,
                                      int g, int n, int chunk, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b < 1 || b > 65535 || l < 1 || h < 1 || g < 1 || h % g != 0 || p != tc::P ||
      (n != 64 && n != 128) || (chunk != 64 && chunk != 128) || l % chunk != 0 ||
      l / chunk > 65535 || static_cast<long long>(b) * h > 65535 ||
      static_cast<long long>(b) * h * (l / chunk) > 2147483647LL ||
      static_cast<size_t>(scratch_floats) != bwd_tc::scratch_floats(b, l, h, g, n, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* dsf = static_cast<const float*>(dstate);
  float* ddf = static_cast<float*>(ddt);
  float* daf = static_cast<float*>(dA);
  float* sc = static_cast<float*>(scratch);
  if (n == 128 && chunk == 128)
    return static_cast<int>(bwd_tc::launch<128, 128>(x, dtf, Af, B, C, dy, dsf, dx, ddf, daf, dB,
                                                     dC, sc, b, l, h, g, stream));
  if (n == 128 && chunk == 64)
    return static_cast<int>(bwd_tc::launch<128, 64>(x, dtf, Af, B, C, dy, dsf, dx, ddf, daf, dB,
                                                    dC, sc, b, l, h, g, stream));
  if (n == 64 && chunk == 128)
    return static_cast<int>(bwd_tc::launch<64, 128>(x, dtf, Af, B, C, dy, dsf, dx, ddf, daf, dB,
                                                    dC, sc, b, l, h, g, stream));
  return static_cast<int>(bwd_tc::launch<64, 64>(x, dtf, Af, B, C, dy, dsf, dx, ddf, daf, dB, dC,
                                                 sc, b, l, h, g, stream));
}

// Each tensor-core backward kernel's shared memory in bytes at state n and
// chunk q (kernel 0: local, 1: chunk, 2: dB/dC), for the check of its
// mirror, kernels/ssd_scan/ops.py::tc_bwd_smem_bytes; -1 for other shapes.
extern "C" long long ssd_scan_bwd_tc_smem(int kernel, int n, int chunk) {
  size_t out[3] = {0, 0, 0};
  if (n == 128 && chunk == 128) {
    out[0] = bwd_tc::LocalLayout<128, 128>::smem;
    out[1] = bwd_tc::ChunkLayout<128, 128>::smem;
    out[2] = bwd_tc::DbdcLayout<128, 128>::smem;
  } else if (n == 128 && chunk == 64) {
    out[0] = bwd_tc::LocalLayout<128, 64>::smem;
    out[1] = bwd_tc::ChunkLayout<128, 64>::smem;
    out[2] = bwd_tc::DbdcLayout<128, 64>::smem;
  } else if (n == 64 && chunk == 128) {
    out[0] = bwd_tc::LocalLayout<64, 128>::smem;
    out[1] = bwd_tc::ChunkLayout<64, 128>::smem;
    out[2] = bwd_tc::DbdcLayout<64, 128>::smem;
  } else if (n == 64 && chunk == 64) {
    out[0] = bwd_tc::LocalLayout<64, 64>::smem;
    out[1] = bwd_tc::ChunkLayout<64, 64>::smem;
    out[2] = bwd_tc::DbdcLayout<64, 64>::smem;
  }
  if (kernel < 0 || kernel > 2 || out[0] == 0) return -1;
  return static_cast<long long>(out[kernel]);
}
