// K3 for bf16 on Hopper: dK and dV of flash attention.
//
// Replaces _dkv_kernel, pass 2 of _flash_bwd_core
// (horovod_tpu/ops/flash_attention.py:237, :297). Semantics as in the header
// of flash_attention.cu: P is recomputed from (q, k, lse), rows with
// lse <= -5e29 have P = 0, dS = P (dP - delta) scale is rounded to Q's dtype
// before dS^T.Q, P to dO's before P^T.dO; `out_f32` writes fp32 partials
// (ring attention sums them).
//
// Bound at the training shape (B 8 x H 12, S 2048, D 64, causal): Q.K^T,
// dO.V^T, P^T.dO and dS^T.Q over the visible half of the scores are
// 103 GFLOP against 153 MB of q, k, v, dO, lse, delta, dk and dv, so the
// kernel is bound by the tensor cores: 104 us at 989 TFLOP/s, against 46 us
// for the bytes at 3.35 TB/s.
//
// Design. Everything is computed transposed, with the kv rows as the rows
// of every accumulator, so no product result goes through shared memory:
//   S^T = K.Q^T and dP^T = V.dO^T    (wgmma, K and V as A from shared memory,
//                                     Q and dO as K-major B),
//   P^T = exp(S^T s - lse[col]),  dS^T = P^T (dP^T - delta[col]) s
//                                    (in registers),
//   dV += P^T.dO and dK += dS^T.Q    (wgmma, P^T and dS^T rounded to bf16 as
//                                     A from registers, dO and Q MN-major B).
// One CTA per (bh, 128 kv rows) with 384 threads: warpgroup 2 is the
// producer, one warp that loads K and V once and streams Q, dO and the
// tile's lse (in log2 units) and delta through a ring of STAGES stages (TMA
// for the tiles, plain loads for the two rows of statistics, every lane
// arriving on the stage's "full" mbarrier); warpgroups 0 and 1 own 64 kv
// rows each and share every streamed tile, which halves the Q/dO traffic
// per kv row. The q loop starts at the causal diagonal, the mask runs only
// on tiles that cross it, and dK and dV stay in registers for the whole
// loop; each CTA owns its rows, so no atomics and the same bits every run.

#include "hopper.cuh"

using namespace hopper;

namespace {

template <int D, int STAGES, int BQ_>
struct DkvCfg {
  static constexpr int BM = 128;  // kv rows per CTA, 64 per consumer warpgroup
  static constexpr int BQ = BQ_;  // query rows per streamed tile
  static constexpr int KV_BYTES = BM * D * 2;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int Q_OFF = V_OFF + KV_BYTES;
  static constexpr int G_OFF = Q_OFF + STAGES * QT_BYTES;
  static constexpr int L_OFF = G_OFF + STAGES * QT_BYTES;  // lse in log2 units, fp32 [STAGES][BQ]
  static constexpr int DL_OFF = L_OFF + STAGES * BQ * 4;   // delta, fp32 [STAGES][BQ]
  static constexpr int BAR_OFF = DL_OFF + STAGES * BQ * 4;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

template <int D, int STAGES, int BQ_>
__global__ void __launch_bounds__(384, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse, const float* __restrict__ delta, void* __restrict__ dk,
                          void* __restrict__ dv, int out_f32, int sq, int skv, int d, int q_off, int kv_off,
                          int causal, float scale, float scale_log2) {
  using C = DkvCfg<D, STAGES, BQ_>;
  constexpr int BQ = C::BQ;
  constexpr int NS = BQ / 2;  // score registers per thread (64 x BQ tile)
  constexpr int DB = D / 64;  // 64-column blocks of the head dim
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_base(smem_raw);
  float* sL = reinterpret_cast<float*>(smem + C::L_OFF);
  float* sDl = reinterpret_cast<float*>(smem + C::DL_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int k0 = blockIdx.x * C::BM;  // the first kv tiles see the most queries
  const int bh = blockIdx.y;
  const int n_q = cdiv(sq, BQ);
  const int i0 = first_q_tile(k0, n_q, q_off, kv_off, causal, BQ);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane: statistics stores, lane 0 also the TMA bytes
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    reg_dealloc<40>();
    if (threadIdx.x < 256 + 32 && i0 < n_q) {
      const int lane = threadIdx.x % 32;
      const size_t base = (size_t)bh * sq;
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * C::KV_BYTES);
        tma_load_tile<C::BM, D>(smem + C::K_OFF, &tk, kvbar, k0, bh);
        tma_load_tile<C::BM, D>(smem + C::V_OFF, &tv, kvbar, k0, bh);
      }
      for (int i = i0; i < n_q; ++i) {
        const int it = i - i0, s = it % STAGES, q0 = i * BQ;
        if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        for (int r = lane; r < BQ; r += 32) {
          float l2 = INFINITY, dl = 0.f;  // rows past sq and rows that see no key: P = 0
          if (q0 + r < sq) {
            const float x = lse[base + q0 + r];
            if (x > -5e29f) l2 = x * LOG2E;
            dl = delta[base + q0 + r];
          }
          sL[s * BQ + r] = l2;
          sDl[s * BQ + r] = dl;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * C::QT_BYTES);
          tma_load_tile<BQ, D>(smem + C::Q_OFF + s * C::QT_BYTES, &tq, &full[s], q0, bh);
          tma_load_tile<BQ, D>(smem + C::G_OFF + s * C::QT_BYTES, &tg, &full[s], q0, bh);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {  // consumers: 64 kv rows each
    reg_alloc<232>();
    const int lane = threadIdx.x % 32;
    const int kw0 = k0 + 64 * wg;  // this warpgroup's first kv row
    const int i0_w = kw0 < skv ? first_q_tile(kw0, n_q, q_off, kv_off, causal, BQ) : n_q;
    const int krow0 = kw0 + acc_row(0);  // this thread's rows: krow0 and krow0 + 8

    float acc_dk[DB][32], acc_dv[DB][32];
#pragma unroll
    for (int b = 0; b < DB; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dk[b][i] = acc_dv[b][i] = 0.f;
    if (i0_w < n_q) mbar_wait(kvbar, 0);

    for (int i = i0; i < n_q; ++i) {
      const int it = i - i0, s = it % STAGES, q0 = i * BQ;
      mbar_wait(&full[s], (it / STAGES) & 1);
      if (i >= i0_w) {
        const unsigned char* sQ = smem + C::Q_OFF + s * C::QT_BYTES;
        const unsigned char* sG = smem + C::G_OFF + s * C::QT_BYTES;
        const float* l2 = sL + s * BQ;
        const float* dl = sDl + s * BQ;
        float acc_s[NS], acc_dp[NS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0>(acc_s, desc_k(smem + C::K_OFF, C::BM, 64 * wg, kk), desc_k(sQ, BQ, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0>(acc_dp, desc_k(smem + C::V_OFF, C::BM, 64 * wg, kk), desc_k(sG, BQ, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // S^T is ready, dP^T may still run
        fence_regs(acc_s);

        // P^T in place of S^T while dP^T runs, then dS^T in place of dP^T,
        // and only then both register-A products: at most the four
        // accumulators are live (at D = 64 about 165 registers), so nothing
        // spills and ptxas need not serialize the wgmma. Keeping P^T.dO in
        // flight while dS^T is computed held P^T's fragments too and did both.
        const bool masked = causal && (long long)q_off + q0 < (long long)kv_off + kw0 + 63;
#pragma unroll
        for (int r = 0; r < NS; ++r) {
          const int c = acc_col(r);
          float p = fast_exp2(acc_s[r] * scale_log2 - l2[c]);
          if (masked && (long long)q_off + q0 + c < (long long)kv_off + krow0 + 8 * ((r / 2) % 2)) p = 0.f;
          acc_s[r] = p;
        }
        wgmma_wait<0>();
        fence_regs(acc_dp);
#pragma unroll
        for (int r = 0; r < NS; ++r) acc_dp[r] = acc_s[r] * (acc_dp[r] - dl[acc_col(r)]) * scale;
        uint32_t pa[BQ / 16][4], pd[BQ / 16][4];
#pragma unroll
        for (int c = 0; c < BQ / 16; ++c) {
          pack_a(pa[c], acc_s, c);
          pack_a(pd[c], acc_dp, c);
        }
#pragma unroll
        for (int b = 0; b < DB; ++b) {
          fence_regs(acc_dk[b]);
          fence_regs(acc_dv[b]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int b = 0; b < DB; ++b) wgmma_rs<1>(acc_dv[b], pa[kk], desc_mn(sG, BQ, kk, b));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int b = 0; b < DB; ++b) wgmma_rs<1>(acc_dk[b], pd[kk], desc_mn(sQ, BQ, kk, b));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int b = 0; b < DB; ++b) {
          fence_regs(acc_dk[b]);
          fence_regs(acc_dv[b]);
        }
      }
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: this thread's two rows of dK and dV, fp32 or bf16
    const size_t base = (size_t)bh * skv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = krow0 + 8 * h;
      if (row >= skv) continue;
#pragma unroll
      for (int b = 0; b < DB; ++b)
#pragma unroll
        for (int r = 2 * h; r < 32; r += 4) {  // registers r, r + 1 of row h
          const int col = 64 * b + acc_col(r);
          if (col >= d) continue;
          const size_t at = (base + row) * d + col;
          if (out_f32) {
            *reinterpret_cast<float2*>(static_cast<float*>(dk) + at) = make_float2(acc_dk[b][r], acc_dk[b][r + 1]);
            *reinterpret_cast<float2*>(static_cast<float*>(dv) + at) = make_float2(acc_dv[b][r], acc_dv[b][r + 1]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dk) + at) =
                __floats2bfloat162_rn(acc_dk[b][r], acc_dk[b][r + 1]);
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dv) + at) =
                __floats2bfloat162_rn(acc_dv[b][r], acc_dv[b][r + 1]);
          }
        }
    }
  }
}

template <int D, int STAGES, int BQ>
int launch(const void* q, const void* k, const void* v, const void* g, const float* lse, const float* delta,
           void* dk, void* dv, int out_f32, int bh, int sq, int skv, int d, int q_off, int kv_off, int causal,
           float scale, cudaStream_t stream) {
  using C = DkvCfg<D, STAGES, BQ>;
  CUtensorMap tq, tg, tk, tv;
  int e = make_map(&tq, q, d, sq, bh, C::BQ);
  if (e == 0) e = make_map(&tg, g, d, sq, bh, C::BQ);
  if (e == 0) e = make_map(&tk, k, d, skv, bh, C::BM);
  if (e == 0) e = make_map(&tv, v, d, skv, bh, C::BM);
  if (e != 0) return e;
  auto kernel = flash_dkv_sm90_kernel<D, STAGES, BQ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(skv, C::BM), bh);
  kernel<<<grid, 384, C::SMEM, stream>>>(tq, tg, tk, tv, lse, delta, dk, dv, out_f32, sq, skv, d, q_off, kv_off,
                                         causal, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Tile configurations: 2 or 3 stages; 0 takes the one measured fastest at
// the training shape, 2. The q tile is 64 rows at D = 64 and 32 rows in 2
// stages at D = 128, so that its two accumulators of 64 x 128 and the
// 64 x 32 score tiles fit the registers.
int hvd_flash_dkv_sm90(const void* q, const void* k, const void* v, const void* g, const float* lse,
                       const float* delta, void* dk, void* dv, int out_f32, int bh, int sq, int skv, int d, int q_off,
                       int kv_off, int causal, float scale, int stages, cudaStream_t stream) {
  if (d > 64) {
    if (stages != 0 && stages != 2) return (int)cudaErrorInvalidValue;
    return launch<128, 2, 32>(q, k, v, g, lse, delta, dk, dv, out_f32, bh, sq, skv, d, q_off, kv_off, causal, scale,
                              stream);
  }
  if (stages == 0) stages = 2;
  if (stages == 2)
    return launch<64, 2, 64>(q, k, v, g, lse, delta, dk, dv, out_f32, bh, sq, skv, d, q_off, kv_off, causal, scale,
                             stream);
  if (stages == 3)
    return launch<64, 3, 64>(q, k, v, g, lse, delta, dk, dv, out_f32, bh, sq, skv, d, q_off, kv_off, causal, scale,
                             stream);
  return (int)cudaErrorInvalidValue;
}
