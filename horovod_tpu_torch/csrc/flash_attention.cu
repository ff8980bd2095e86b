// Flash attention for Hopper (sm_90a): the C entry points of the forward
// pass (K1), the dQ pass (K2) and the dK/dV pass (K3) of a causal or full
// softmax attention on [BH, S, D] tensors in bf16 or fp32, with fp32 softmax
// statistics, and the fp32 kernels of all three.
//
// Semantics (shared with the plain PyTorch versions in
// horovod_tpu_torch/ops/flash_attention.py):
//   * query row r sees key c iff  !causal || q_offset + r >= kv_offset + c;
//   * a row that sees no key outputs 0 and lse = -1e30;
//   * products take the tensors' own dtype with fp32 accumulation, P is
//     cast to V's dtype before P.V, dS to K's (Q's) dtype before dS.K
//     (dS^T.Q);
//   * ragged sequence tails are masked here, so any S > 1 is accepted.
//
// Layout of the work. The TPU kernels walk a sequential grid and carry
// (m, l, acc) in VMEM from one grid step to the next. Blocks of a CUDA grid
// run in no order, so the sequential axis becomes a loop inside one CTA:
//   K1: one CTA per (bh, q tile), looping over K/V tiles up to the causal
//       diagonal, carrying (m, l) and the fp32 accumulator;
//   K2: one CTA per (bh, q tile), looping over K/V tiles, dQ in fp32;
//   K3: one CTA per (bh, kv tile), looping over q tiles from the diagonal,
//       dK and dV in fp32.
// The two backward passes recompute P from (q, k, lse), need no atomics and
// give the same bits on every run.
//
// Two designs. bf16, the training path, runs the Hopper kernels of
// flash_fwd_sm90.cu, flash_dq_sm90.cu and flash_dkv_sm90.cu: wgmma with
// register-resident accumulators fed by TMA (their notes say how). fp32, the
// exact parity path, runs the kernels of this file: every product a scalar
// FMA loop (exact fp32, no TF32) over tiles of 32 rows in shared memory, so
// that the largest head dim still fits, with one warp per row for the
// softmax arithmetic. They serve parity checks, not speed.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

#define HVD_NEG_INF (-1e30f)

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int FPAD = 4;  // fp32 tile row padding (16 bytes)

// Rows per q tile and per kv tile, and the row padding of input tiles.
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int B = 32; static constexpr int PAD = 4; };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Bump allocator over the dynamic shared memory; the host runs the same
// sequence to size the launch.
struct Carve {
  size_t off = 0;
  template <typename U> __host__ __device__ size_t take(size_t n) {
    size_t at = off;
    off = align128(off + n * sizeof(U));
    return at;
  }
};

// Shared-memory plan of each kernel. Row strides: ldt for input tiles (T),
// lds for fp32 score tiles, ldp for the T copy of P / dS, lda for fp32
// accumulators. On the fp32 path P and dS overwrite the score tiles in
// place (each element is read and written by the same thread).
template <typename T> struct Plan {
  static constexpr int B = Tile<T>::B;
  static constexpr bool F32 = std::is_same<T, float>::value;
  int ldt, lds, ldp, lda;
  __host__ __device__ explicit Plan(int dp)
      : ldt(dp + Tile<T>::PAD), lds(B + FPAD), ldp(F32 ? B + FPAD : B + Tile<T>::PAD), lda(dp + FPAD) {}
};

template <typename T> struct FwdSmem {
  size_t q, k, v, s, p, acc, m, l, total;
  __host__ __device__ explicit FwdSmem(const Plan<T>& pl) {
    constexpr int B = Plan<T>::B;
    Carve c;
    q = c.take<T>(B * pl.ldt); k = c.take<T>(B * pl.ldt); v = c.take<T>(B * pl.ldt);
    s = c.take<float>(B * pl.lds);
    p = s;  // K1 runs here only in fp32, which writes P in place of S
    acc = c.take<float>(B * pl.lda);
    m = c.take<float>(B); l = c.take<float>(B);
    total = c.off;
  }
};

template <typename T> struct BwdSmem {
  size_t q, g, k, v, s, dp, p, ds, acc1, acc2, lse, delta, total;
  __host__ __device__ BwdSmem(const Plan<T>& pl, bool two_acc) {
    constexpr int B = Plan<T>::B;
    Carve c;
    q = c.take<T>(B * pl.ldt); g = c.take<T>(B * pl.ldt);
    k = c.take<T>(B * pl.ldt); v = c.take<T>(B * pl.ldt);
    s = c.take<float>(B * pl.lds); dp = c.take<float>(B * pl.lds);
    p = s;  // only K3 in fp32 writes P, in place of S
    ds = Plan<T>::F32 ? dp : c.take<T>(B * pl.ldp);
    acc1 = c.take<float>(B * pl.lda);
    acc2 = two_acc ? c.take<float>(B * pl.lda) : acc1;
    lse = c.take<float>(B); delta = c.take<float>(B);
    total = c.off;
  }
};

// rows x dp tile of a [S, d] row-major matrix, starting at row0, into shared
// memory with row stride ld; rows past n and columns past d are zero.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, int row0, int n, int d, int dp, int rows) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = dp / V;
  for (int i = threadIdx.x; i < rows * vpr; i += THREADS) {
    const int r = i / vpr, c = (i % vpr) * V, gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < n && c < d) val = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ void load_rows(float* dst, const float* src, int row0, int n, int rows, float fill) {
  for (int r = threadIdx.x; r < rows; r += THREADS) dst[r] = row0 + r < n ? src[row0 + r] : fill;
}

__device__ void zero(float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += THREADS) dst[i] = 0.f;
}

// C[M x N] (fp32, row-major, ldc) = (acc ? C : 0) + A[M x K] . B[K x N],
// scalar FMA, one C element per thread at a time.
// A_COL: A(m, k) lives at A[k * lda + m], else at A[m * lda + k].
// B_COL: B(k, n) lives at B[n * ldb + k], else at B[k * ldb + n].
template <bool A_COL, bool B_COL>
__device__ void tile_mma(float* C, int ldc, const float* A, int lda, const float* B, int ldb, int M, int N,
                         int K, bool acc) {
  for (int i = threadIdx.x; i < M * N; i += THREADS) {
    const int m = i / N, n = i % N;
    float s = acc ? C[m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k)
      s = fmaf(A_COL ? A[k * lda + m] : A[m * lda + k], B_COL ? B[n * ldb + k] : B[k * ldb + n], s);
    C[m * ldc + n] = s;
  }
}

// ---------------------------------------------------------------------------
// K1 in fp32: forward. Replaces _flash_fwd_impl / _kernel / _kernel_lse
// (horovod_tpu/ops/flash_attention.py:128, :53, :122) for fp32 inputs, the
// exact parity path; bf16 runs flash_fwd_sm90.cu. The design keeps Q in
// shared memory for the whole loop, stops at the causal diagonal and
// launches the q tiles with the most kv tiles first.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int sq, int skv, int d, int dp, int q_off,
                     int kv_off, int causal, float scale) {
  static_assert(std::is_same<T, float>::value, "bf16 K1 is flash_fwd_sm90_kernel");
  constexpr int B = Plan<T>::B;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan<T> pl(dp);
  const FwdSmem<T> at(pl);
  T* sQ = reinterpret_cast<T*>(smem + at.q);
  T* sK = reinterpret_cast<T*>(smem + at.k);
  T* sV = reinterpret_cast<T*>(smem + at.v);
  float* sS = reinterpret_cast<float*>(smem + at.s);
  T* sP = reinterpret_cast<T*>(smem + at.p);
  float* sAcc = reinterpret_cast<float*>(smem + at.acc);
  float* sM = reinterpret_cast<float*>(smem + at.m);
  float* sL = reinterpret_cast<float*>(smem + at.l);

  const int n_q = (sq + B - 1) / B;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * B;  // longest causal rows first
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * skv * d;
  const T* vb = v + (size_t)bh * skv * d;

  load_tile(sQ, pl.ldt, qb, q0, sq, d, dp, B);
  zero(sAcc, B * pl.lda);
  for (int r = threadIdx.x; r < B; r += THREADS) { sM[r] = HVD_NEG_INF; sL[r] = 0.f; }
  const int n_kv = hopper::kv_tiles(q0, min(q0 + B, sq), skv, q_off, kv_off, causal, B);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * B;
    load_tile(sK, pl.ldt, kb, k0, skv, d, dp, B);
    load_tile(sV, pl.ldt, vb, k0, skv, d, dp, B);
    __syncthreads();
    tile_mma<false, true>(sS, pl.lds, sQ, pl.ldt, sK, pl.ldt, B, B, dp, false);  // S = Q K^T
    __syncthreads();
    for (int r = warp; r < B; r += WARPS) {  // online softmax, one warp per row
      const long long qpos = (long long)q_off + q0 + r;
      float s[B / 32];
      float mx = HVD_NEG_INF;
#pragma unroll
      for (int c = 0; c < B / 32; ++c) {
        const int col = lane + 32 * c, kpos = k0 + col;
        const bool vis = kpos < skv && (!causal || qpos >= (long long)kv_off + kpos);
        s[c] = vis ? sS[r * pl.lds + col] * scale : HVD_NEG_INF;
        mx = fmaxf(mx, s[c]);
      }
      mx = warp_max(mx);
      const float m_old = sM[r], m_new = fmaxf(m_old, mx);
      const bool none = m_new <= HVD_NEG_INF / 2;  // nothing visible yet
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < B / 32; ++c) {
        const float p = none ? 0.f : expf(s[c] - m_new);
        rs += p;
        sP[r * pl.ldp + lane + 32 * c] = from_f<T>(p);
      }
      rs = warp_sum(rs);
      const float alpha = m_old <= HVD_NEG_INF / 2 ? 0.f : expf(m_old - m_new);
      for (int col = lane; col < dp; col += 32) sAcc[r * pl.lda + col] *= alpha;
      __syncwarp();
      if (lane == 0) { sL[r] = sL[r] * alpha + rs; sM[r] = m_new; }
    }
    __syncthreads();
    tile_mma<false, false>(sAcc, pl.lda, sP, pl.ldp, sV, pl.ldt, B, dp, B, true);  // acc += P V
    __syncthreads();
  }
  if (n_kv == 0) __syncthreads();

  T* ob = o + (size_t)bh * sq * d;
  for (int i = threadIdx.x; i < B * d; i += THREADS) {
    const int r = i / d, c = i % d;
    if (q0 + r < sq) {
      const float l = sL[r];
      ob[(size_t)(q0 + r) * d + c] = from_f<T>(sAcc[r * pl.lda + c] / (l == 0.f ? 1.f : l));
    }
  }
  for (int r = threadIdx.x; r < B; r += THREADS) {
    if (q0 + r < sq) {
      const float l = sL[r];
      lse[(size_t)bh * sq + q0 + r] = l == 0.f ? HVD_NEG_INF : sM[r] + logf(l);
    }
  }
}

// P = exp(S*scale - lse) under the mask, and dS = P (dP - delta) scale, for
// one tile of rows (q) and columns (k); one warp per row.
template <typename T, bool WRITE_P>
__device__ void p_and_ds(const Plan<T>& pl, const float* sS, const float* sDP, T* sP, T* sDS,
                         const float* sLse, const float* sDelta, int q0, int k0, int skv, int q_off,
                         int kv_off, int causal, float scale) {
  constexpr int B = Plan<T>::B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < B; r += WARPS) {
    const long long qpos = (long long)q_off + q0 + r;
    const float l = sLse[r], dl = sDelta[r];
    const bool none = l <= HVD_NEG_INF / 2;
#pragma unroll
    for (int c = 0; c < B / 32; ++c) {
      const int col = lane + 32 * c, kpos = k0 + col;
      const bool vis = !none && kpos < skv && (!causal || qpos >= (long long)kv_off + kpos);
      const float s = sS[r * pl.lds + col], dp = sDP[r * pl.lds + col];
      const float p = vis ? expf(s * scale - l) : 0.f;
      if (WRITE_P) sP[r * pl.ldp + col] = from_f<T>(p);
      sDS[r * pl.ldp + col] = from_f<T>(p * (dp - dl) * scale);
    }
  }
}

// The first `rows` rows of an fp32 accumulator tile to rows row0.. of a
// [*, d] output in T or fp32.
template <typename T>
__device__ void store_tile(void* dst, bool out_f32, const float* acc, int lda, size_t row0, int rows, int d) {
  for (int i = threadIdx.x; i < rows * d; i += THREADS) {
    const int r = i / d, c = i % d;
    const size_t at = (row0 + r) * d + c;
    if (out_f32) static_cast<float*>(dst)[at] = acc[r * lda + c];
    else static_cast<T*>(dst)[at] = from_f<T>(acc[r * lda + c]);
  }
}

// ---------------------------------------------------------------------------
// K2 in fp32: dQ. Replaces _dq_kernel, pass 1 of _flash_bwd_core
// (horovod_tpu/ops/flash_attention.py:191, :297) for fp32 inputs, the exact
// parity path; bf16 runs flash_dq_sm90.cu. The design recomputes P from lse
// rather than reading an S x S matrix, keeps Q, dO and the dQ accumulator on
// chip for the whole loop, and gives each CTA its own dQ rows, so no atomics.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
                    void* __restrict__ dq, int out_f32, int sq, int skv, int d, int dp, int q_off, int kv_off,
                    int causal, float scale) {
  static_assert(std::is_same<T, float>::value, "bf16 K2 is flash_dq_sm90_kernel");
  constexpr int B = Plan<T>::B;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan<T> pl(dp);
  const BwdSmem<T> at(pl, false);
  T* sQ = reinterpret_cast<T*>(smem + at.q);
  T* sG = reinterpret_cast<T*>(smem + at.g);
  T* sK = reinterpret_cast<T*>(smem + at.k);
  T* sV = reinterpret_cast<T*>(smem + at.v);
  float* sS = reinterpret_cast<float*>(smem + at.s);
  float* sDP = reinterpret_cast<float*>(smem + at.dp);
  T* sDS = reinterpret_cast<T*>(smem + at.ds);
  float* sAcc = reinterpret_cast<float*>(smem + at.acc1);
  float* sLse = reinterpret_cast<float*>(smem + at.lse);
  float* sDelta = reinterpret_cast<float*>(smem + at.delta);

  const int n_q = (sq + B - 1) / B;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * B;
  const int bh = blockIdx.y;
  const size_t qbase = (size_t)bh * sq, kbase = (size_t)bh * skv;

  load_tile(sQ, pl.ldt, q + qbase * d, q0, sq, d, dp, B);
  load_tile(sG, pl.ldt, g + qbase * d, q0, sq, d, dp, B);
  load_rows(sLse, lse + qbase, q0, sq, B, HVD_NEG_INF);
  load_rows(sDelta, delta + qbase, q0, sq, B, 0.f);
  zero(sAcc, B * pl.lda);
  const int n_kv = hopper::kv_tiles(q0, min(q0 + B, sq), skv, q_off, kv_off, causal, B);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * B;
    load_tile(sK, pl.ldt, k + kbase * d, k0, skv, d, dp, B);
    load_tile(sV, pl.ldt, v + kbase * d, k0, skv, d, dp, B);
    __syncthreads();
    tile_mma<false, true>(sS, pl.lds, sQ, pl.ldt, sK, pl.ldt, B, B, dp, false);   // S = Q K^T
    tile_mma<false, true>(sDP, pl.lds, sG, pl.ldt, sV, pl.ldt, B, B, dp, false);  // dP = dO V^T
    __syncthreads();
    p_and_ds<T, false>(pl, sS, sDP, nullptr, sDS, sLse, sDelta, q0, k0, skv, q_off, kv_off, causal, scale);
    __syncthreads();
    tile_mma<false, false>(sAcc, pl.lda, sDS, pl.ldp, sK, pl.ldt, B, dp, B, true);  // dQ += dS K
    __syncthreads();
  }
  if (n_kv == 0) __syncthreads();
  store_tile<T>(dq, out_f32, sAcc, pl.lda, qbase + q0, min(B, sq - q0), d);
}

// ---------------------------------------------------------------------------
// K3 in fp32: dK and dV. Replaces _dkv_kernel, pass 2 of _flash_bwd_core
// (horovod_tpu/ops/flash_attention.py:237, :297) for fp32 inputs, the exact
// parity path; bf16 runs flash_dkv_sm90.cu. The design keeps K, V and both
// fp32 accumulators on chip for the whole loop, starts the loop at the
// causal diagonal, and gives each CTA its own dK/dV rows, so no atomics.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
                     void* __restrict__ dk, void* __restrict__ dv, int out_f32, int sq, int skv, int d, int dp,
                     int q_off, int kv_off, int causal, float scale) {
  static_assert(std::is_same<T, float>::value, "bf16 K3 is flash_dkv_sm90_kernel");
  constexpr int B = Plan<T>::B;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan<T> pl(dp);
  const BwdSmem<T> at(pl, true);
  T* sQ = reinterpret_cast<T*>(smem + at.q);
  T* sG = reinterpret_cast<T*>(smem + at.g);
  T* sK = reinterpret_cast<T*>(smem + at.k);
  T* sV = reinterpret_cast<T*>(smem + at.v);
  float* sS = reinterpret_cast<float*>(smem + at.s);
  float* sDP = reinterpret_cast<float*>(smem + at.dp);
  T* sP = reinterpret_cast<T*>(smem + at.p);
  T* sDS = reinterpret_cast<T*>(smem + at.ds);
  float* sDK = reinterpret_cast<float*>(smem + at.acc1);
  float* sDV = reinterpret_cast<float*>(smem + at.acc2);
  float* sLse = reinterpret_cast<float*>(smem + at.lse);
  float* sDelta = reinterpret_cast<float*>(smem + at.delta);

  const int k0 = blockIdx.x * B;  // the first kv tiles see the most queries
  const int bh = blockIdx.y;
  const size_t qbase = (size_t)bh * sq, kbase = (size_t)bh * skv;

  load_tile(sK, pl.ldt, k + kbase * d, k0, skv, d, dp, B);
  load_tile(sV, pl.ldt, v + kbase * d, k0, skv, d, dp, B);
  zero(sDK, B * pl.lda);
  zero(sDV, B * pl.lda);
  const int n_q = (sq + B - 1) / B;
  const int i0 = hopper::first_q_tile(k0, n_q, q_off, kv_off, causal, B);

  for (int i = i0; i < n_q; ++i) {
    const int q0 = i * B;
    load_tile(sQ, pl.ldt, q + qbase * d, q0, sq, d, dp, B);
    load_tile(sG, pl.ldt, g + qbase * d, q0, sq, d, dp, B);
    load_rows(sLse, lse + qbase, q0, sq, B, HVD_NEG_INF);
    load_rows(sDelta, delta + qbase, q0, sq, B, 0.f);
    __syncthreads();
    tile_mma<false, true>(sS, pl.lds, sQ, pl.ldt, sK, pl.ldt, B, B, dp, false);   // S = Q K^T
    tile_mma<false, true>(sDP, pl.lds, sG, pl.ldt, sV, pl.ldt, B, B, dp, false);  // dP = dO V^T
    __syncthreads();
    p_and_ds<T, true>(pl, sS, sDP, sP, sDS, sLse, sDelta, q0, k0, skv, q_off, kv_off, causal, scale);
    __syncthreads();
    tile_mma<true, false>(sDV, pl.lda, sP, pl.ldp, sG, pl.ldt, B, dp, B, true);   // dV += P^T dO
    tile_mma<true, false>(sDK, pl.lda, sDS, pl.ldp, sQ, pl.ldt, B, dp, B, true);  // dK += dS^T Q
    __syncthreads();
  }
  if (i0 >= n_q) __syncthreads();
  store_tile<T>(dk, out_f32, sDK, pl.lda, kbase + k0, min(B, skv - k0), d);
  store_tile<T>(dv, out_f32, sDV, pl.lda, kbase + k0, min(B, skv - k0), d);
}

inline int round16(int d) { return (d + 15) / 16 * 16; }

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq, int skv, int d,
               int q_off, int kv_off, int causal, float scale, cudaStream_t stream) {
  const int dp = round16(d);
  const size_t smem = FwdSmem<T>(Plan<T>(dp)).total;
  cudaError_t e = prepare(flash_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + Plan<T>::B - 1) / Plan<T>::B, bh);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse,
      sq, skv, d, dp, q_off, kv_off, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const float* lse, const float* delta,
              void* dq, int out_f32, int bh, int sq, int skv, int d, int q_off, int kv_off, int causal,
              float scale, cudaStream_t stream) {
  const int dp = round16(d);
  const size_t smem = BwdSmem<T>(Plan<T>(dp), false).total;
  cudaError_t e = prepare(flash_dq_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + Plan<T>::B - 1) / Plan<T>::B, bh);
  flash_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
      lse, delta, dq, out_f32, sq, skv, d, dp, q_off, kv_off, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const float* lse,
               const float* delta, void* dk, void* dv, int out_f32, int bh, int sq, int skv, int d, int q_off,
               int kv_off, int causal, float scale, cudaStream_t stream) {
  const int dp = round16(d);
  const size_t smem = BwdSmem<T>(Plan<T>(dp), true).total;
  cudaError_t e = prepare(flash_dkv_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((skv + Plan<T>::B - 1) / Plan<T>::B, bh);
  flash_dkv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
      lse, delta, dk, dv, out_f32, sq, skv, d, dp, q_off, kv_off, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = fp32, 1 = bf16. Each call
// launches on `stream` and returns the CUDA error code of the launch.
extern "C" {

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq, int skv,
                  int d, int q_off, int kv_off, int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return hvd_flash_fwd_sm90(q, k, v, o, lse, bh, sq, skv, d, q_off, kv_off, causal, scale, 0, 0, s);
  return launch_fwd<float>(q, k, v, o, lse, bh, sq, skv, d, q_off, kv_off, causal, scale, s);
}

int hvd_flash_dq(const void* q, const void* k, const void* v, const void* g, const float* lse,
                 const float* delta, void* dq, int out_f32, int bh, int sq, int skv, int d, int q_off,
                 int kv_off, int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return hvd_flash_dq_sm90(q, k, v, g, lse, delta, dq, out_f32, bh, sq, skv, d, q_off, kv_off, causal, scale, 0,
                             0, s);
  return launch_dq<float>(q, k, v, g, lse, delta, dq, out_f32, bh, sq, skv, d, q_off, kv_off, causal, scale, s);
}

int hvd_flash_dkv(const void* q, const void* k, const void* v, const void* g, const float* lse,
                  const float* delta, void* dk, void* dv, int out_f32, int bh, int sq, int skv, int d,
                  int q_off, int kv_off, int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return hvd_flash_dkv_sm90(q, k, v, g, lse, delta, dk, dv, out_f32, bh, sq, skv, d, q_off, kv_off, causal,
                              scale, 0, s);
  return launch_dkv<float>(q, k, v, g, lse, delta, dk, dv, out_f32, bh, sq, skv, d, q_off, kv_off, causal,
                           scale, s);
}

const char* hvd_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
