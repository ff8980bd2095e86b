// K2 for bf16 on Hopper: dQ of flash attention.
//
// Replaces _dq_kernel, pass 1 of _flash_bwd_core
// (horovod_tpu/ops/flash_attention.py:191, :297). Semantics as in the header
// of flash_attention.cu: P is recomputed from (q, k, lse), rows with
// lse <= -5e29 have P = 0, dS = P (dP - delta) scale is rounded to K's dtype
// before dS.K, dQ sums in fp32; `out_f32` writes fp32 partials (ring
// attention sums them).
//
// Bound at the training shape (B 8 x H 12, S 2048, D 64, causal): Q.K^T,
// dO.V^T and dS.K over the visible half of the scores are 77.3 GFLOP against
// 127 MB of q, k, v, dO, lse, delta and dq, so the kernel is bound by the
// tensor cores: 78 us at 989 TFLOP/s, against 38 us for the bytes at 3.35 TB/s.
//
// Design. One CTA per (bh, 128 query rows), the tiles with the longest
// causal rows launched first; 384 threads in three warpgroups:
//   * warpgroup 2 is the producer: one thread loads the CTA's Q and dO tiles
//     once and keeps K/V tiles of BN keys in flight through a ring of STAGES
//     shared-memory stages by TMA, each stage with a "full" mbarrier (TMA
//     bytes) and an "empty" one (one arrival per consumer warp); it gives
//     its registers away (setmaxnreg) to
//   * warpgroups 0 and 1, the consumers, 64 query rows each. The rows' lse
//     (in log2 units, +inf where P is 0) and delta are constants of the
//     thread, read once. A consumer works through each kv tile in blocks of
//     64 keys:
//       S = Q.K^T and dP = dO.V^T  (wgmma, both operands K-major in shared
//                                   memory),
//       P = 2^(S scale log2e - lse) under the mask, dS = P scale (dP - delta)
//                                  (in registers),
//       dQ += dS.K                 (wgmma, dS rounded to bf16 as the register
//                                   A operand, the same K tile read MN-major).
// dQ stays in registers for the whole loop; no product result goes through
// shared memory. S and dP of block u are issued ahead of dQ's product of
// block u-1, so P is computed while dP_u and that product run on the tensor
// cores, and dS while the product does; the three are issued without a
// branch between them (block 0, which has no product before it, is peeled
// off), since a wgmma on a path the compiler cannot prove uniform makes it
// serialize them all (ptxas C7520). Working in 64-key blocks keeps at most
// S, dP, dQ and one block of dS fragments live (112 registers at D 64),
// whatever the tile, so BN only sets how much each TMA stage carries: 0
// bytes of spill at D 64. A warpgroup stops computing at its own causal
// diagonal but still waits for and releases every tile of the CTA, so the
// ring's phases stay in step. Taking turns between the two warpgroups, as
// K1 does, measured no faster. Each CTA owns its dQ rows: no atomics, the
// same bits every run. 128 keys in 2 stages were measured fastest at the
// training shape (chip_smoke.py --tune; PERF.md).

#include "hopper.cuh"

using namespace hopper;

namespace {

template <int D, int BN, int STAGES>
struct DqCfg {
  static constexpr int BM = 128;  // query rows per CTA, 64 per consumer warpgroup
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int G_OFF = Q_OFF + Q_BYTES;
  static constexpr int K_OFF = G_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

template <int D, int BN, int STAGES>
__global__ void __launch_bounds__(384, 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                         const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ lse, const float* __restrict__ delta, void* __restrict__ dq,
                         int out_f32, int sq, int skv, int d, int q_off, int kv_off, int causal, float scale,
                         float scale_log2) {
  using C = DqCfg<D, BN, STAGES>;
  constexpr int NB = BN / 64;  // 64-key blocks of a kv tile
  constexpr int DB = D / 64;   // 64-column blocks of the head dim
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int n_q = cdiv(sq, C::BM);
  const int q0 = (n_q - 1 - (int)blockIdx.x) * C::BM;  // longest causal rows first
  const int bh = blockIdx.y;
  const int n_kv = kv_tiles(q0, min(q0 + C::BM, sq), skv, q_off, kv_off, causal, BN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    reg_dealloc<40>();
    if (threadIdx.x == 256 && n_kv > 0) {
      mbar_expect_tx(qbar, 2 * C::Q_BYTES);
      tma_load_tile<C::BM, D>(smem + C::Q_OFF, &tq, qbar, q0, bh);
      tma_load_tile<C::BM, D>(smem + C::G_OFF, &tg, qbar, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        tma_load_tile<BN, D>(smem + C::K_OFF + s * C::KV_BYTES, &tk, &full[s], j * BN, bh);
        tma_load_tile<BN, D>(smem + C::V_OFF + s * C::KV_BYTES, &tv, &full[s], j * BN, bh);
      }
    }
  } else {  // consumers: 64 query rows each
    reg_alloc<232>();
    const int lane = threadIdx.x % 32;
    const int qw0 = q0 + 64 * wg;       // this warpgroup's first query row
    const int row0 = qw0 + acc_row(0);  // this thread's rows: row0 and row0 + 8
    // the 64-key blocks this warpgroup's rows see, and the kv tiles they fill
    const int n_blk = qw0 < sq ? kv_tiles(qw0, min(qw0 + 64, sq), skv, q_off, kv_off, causal, 64) : 0;
    const int n_mine = cdiv(n_blk, NB);
    const unsigned char* sQ = smem + C::Q_OFF;
    const unsigned char* sG = smem + C::G_OFF;
    const size_t base = (size_t)bh * sq;

    float l2[2], dl[2];  // rows past sq and rows that see no key: P = 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      l2[h] = INFINITY;
      dl[h] = 0.f;
      if (row < sq) {
        const float x = lse[base + row];
        if (x > -5e29f) l2[h] = x * LOG2E;
        dl[h] = delta[base + row];
      }
    }

    float acc_dq[DB][32];
#pragma unroll
    for (int b = 0; b < DB; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dq[b][i] = 0.f;
    float acc_s[32], acc_dp[32];  // S then P scale, dP then dS, of one 64-key block
    uint32_t pd[4][4];            // dS of the block whose dQ product is next, as A fragments

    auto k_tile = [&](int j) { return smem + C::K_OFF + (j % STAGES) * C::KV_BYTES; };
    auto v_tile = [&](int j) { return smem + C::V_OFF + (j % STAGES) * C::KV_BYTES; };
    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(&empty[j % STAGES]);
    };
    // dQ += dS_u.K_u with dS_u in pd (started, not waited for)
    auto start_dq = [&](int u) {
      const unsigned char* sK = k_tile(u / NB);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int b = 0; b < DB; ++b) wgmma_rs<1>(acc_dq[b], pd[c], desc_mn(sK, BN, 4 * (u % NB) + c, b));
    };

    // S_u = Q.K_u^T and dP_u = dO.V_u^T, two commit groups (started, not waited for)
    auto start_s_dp = [&](int u) {
      const unsigned char* sK = k_tile(u / NB);
      const unsigned char* sV = v_tile(u / NB);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0>(acc_s, desc_k(sQ, C::BM, 64 * wg, kk), desc_k(sK, BN, 64 * (u % NB), kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0>(acc_dp, desc_k(sG, C::BM, 64 * wg, kk), desc_k(sV, BN, 64 * (u % NB), kk), kk > 0);
      wgmma_commit();
    };
    // Behind S_u, dP_u and one more commit group (the previous block's dQ
    // product): P_u scale in place of S_u as soon as S_u is ready, dS_u in
    // place of dP_u, then wait for the last group.
    auto p_and_ds = [&](int u) {
      const int k0 = 64 * u;
      wgmma_wait<2>();
      fence_regs(acc_s);
      const bool masked = k0 + 64 > skv || (causal && (long long)kv_off + k0 + 63 > (long long)q_off + qw0);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        float p = fast_exp2(acc_s[r] * scale_log2 - l2[(r / 2) % 2]);
        if (masked) {
          const int kpos = k0 + acc_col(r);
          const long long qpos = (long long)q_off + row0 + 8 * ((r / 2) % 2);
          if (kpos >= skv || (causal && qpos < (long long)kv_off + kpos)) p = 0.f;
        }
        acc_s[r] = p * scale;
      }
      wgmma_wait<1>();
      fence_regs(acc_dp);
#pragma unroll
      for (int r = 0; r < 32; ++r) acc_dp[r] = acc_s[r] * (acc_dp[r] - dl[(r / 2) % 2]);
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < DB; ++b) fence_regs(acc_dq[b]);
    };

    // Block 0 has no dQ product before it; every later block u issues its S
    // and dP ahead of block u-1's dQ product, all three unconditionally, so
    // the compiler keeps the wgmma asynchronous.
    if (n_blk > 0) {
      mbar_wait(qbar, 0);
      mbar_wait(&full[0], 0);
      wgmma_fence();
      start_s_dp(0);
      wgmma_commit();  // empty, so that p_and_ds counts the same groups
      p_and_ds(0);
#pragma unroll
      for (int c = 0; c < 4; ++c) pack_a(pd[c], acc_dp, c);
    }
    for (int u = 1; u < n_blk; ++u) {
      const int j = u / NB, h = u % NB;
      if (h == 0) mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
#pragma unroll
      for (int b = 0; b < DB; ++b) fence_regs(acc_dq[b]);
      wgmma_fence();
      start_s_dp(u);
      start_dq(u - 1);
      wgmma_commit();
      p_and_ds(u);
      if (h == 0) release(j - 1);  // block u-1's dQ product was the last reader of tile j-1
#pragma unroll
      for (int c = 0; c < 4; ++c) pack_a(pd[c], acc_dp, c);
    }
    if (n_blk > 0) {  // the last block's dQ product
#pragma unroll
      for (int b = 0; b < DB; ++b) fence_regs(acc_dq[b]);
      wgmma_fence();
      start_dq(n_blk - 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < DB; ++b) fence_regs(acc_dq[b]);
      release(n_mine - 1);
    }
    // tiles past this warpgroup's diagonal: wait for each and hand it back
    for (int j = n_mine; j < n_kv; ++j) {
      mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
      release(j);
    }

    // epilogue: this thread's two rows of dQ, fp32 or bf16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
#pragma unroll
      for (int b = 0; b < DB; ++b)
#pragma unroll
        for (int r = 2 * h; r < 32; r += 4) {  // registers r, r + 1 of row h
          const int col = 64 * b + acc_col(r);
          if (col >= d) continue;
          const size_t at = (base + row) * d + col;
          if (out_f32)
            *reinterpret_cast<float2*>(static_cast<float*>(dq) + at) = make_float2(acc_dq[b][r], acc_dq[b][r + 1]);
          else
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dq) + at) =
                __floats2bfloat162_rn(acc_dq[b][r], acc_dq[b][r + 1]);
        }
    }
  }
}

template <int D, int BN, int STAGES>
int launch(const void* q, const void* k, const void* v, const void* g, const float* lse, const float* delta,
           void* dq, int out_f32, int bh, int sq, int skv, int d, int q_off, int kv_off, int causal, float scale,
           cudaStream_t stream) {
  using C = DqCfg<D, BN, STAGES>;
  CUtensorMap tq, tg, tk, tv;
  int e = make_map(&tq, q, d, sq, bh, C::BM);
  if (e == 0) e = make_map(&tg, g, d, sq, bh, C::BM);
  if (e == 0) e = make_map(&tk, k, d, skv, bh, BN);
  if (e == 0) e = make_map(&tv, v, d, skv, bh, BN);
  if (e != 0) return e;
  auto kernel = flash_dq_sm90_kernel<D, BN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(sq, C::BM), bh);
  kernel<<<grid, 384, C::SMEM, stream>>>(tq, tg, tk, tv, lse, delta, dq, out_f32, sq, skv, d, q_off, kv_off, causal,
                                         scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Tile configurations: bn keys per kv tile (64 or 128) and stages (2 or 3);
// 0 takes the one measured fastest at the training shape, 128 keys in 2
// stages. D = 128 takes 64 keys in 2 stages, so that Q, dO and the K/V ring
// fit the shared memory with room to spare.
int hvd_flash_dq_sm90(const void* q, const void* k, const void* v, const void* g, const float* lse,
                      const float* delta, void* dq, int out_f32, int bh, int sq, int skv, int d, int q_off,
                      int kv_off, int causal, float scale, int bn, int stages, cudaStream_t stream) {
  if (d > 64) {
    if ((bn != 0 && bn != 64) || (stages != 0 && stages != 2)) return (int)cudaErrorInvalidValue;
    return launch<128, 64, 2>(q, k, v, g, lse, delta, dq, out_f32, bh, sq, skv, d, q_off, kv_off, causal, scale,
                              stream);
  }
  if (bn == 0) bn = 128;
  if (stages == 0) stages = 2;
#define HVD_DQ_CASE(BN_, ST_)                                                                                   \
  if (bn == BN_ && stages == ST_)                                                                               \
    return launch<64, BN_, ST_>(q, k, v, g, lse, delta, dq, out_f32, bh, sq, skv, d, q_off, kv_off, causal, scale, \
                                stream);
  HVD_DQ_CASE(64, 2)
  HVD_DQ_CASE(64, 3)
  HVD_DQ_CASE(128, 2)
  HVD_DQ_CASE(128, 3)
#undef HVD_DQ_CASE
  return (int)cudaErrorInvalidValue;
}
