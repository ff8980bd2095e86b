// K1 for bf16 on Hopper: the flash-attention forward, out and fp32 lse.
//
// Replaces _flash_fwd_impl / _kernel / _kernel_lse
// (horovod_tpu/ops/flash_attention.py:128, :53, :122). Semantics as in the
// header of flash_attention.cu: query row r sees key c iff !causal ||
// q_off + r >= kv_off + c; a row that sees no key outputs 0 with lse -1e30;
// P is rounded to bf16 before P.V; ragged tails are masked here.
//
// Bound at the training shape (B 8 x H 12, S 2048, D 64, causal): Q.K^T and
// P.V over the visible half of the scores are 51.5 GFLOP against 101 MB of
// q, k, v, o and lse, so the kernel is bound by the tensor cores: 52 us at
// 989 TFLOP/s, against 30 us for the bytes at 3.35 TB/s.
//
// Design. One CTA per (bh, 128 query rows), the tiles with the longest
// causal rows launched first; 384 threads in three warpgroups:
//   * warpgroup 2 is the producer: one thread loads the CTA's Q tile once
//     and keeps K/V tiles in flight through a ring of STAGES shared-memory
//     stages by TMA, each stage with a "full" mbarrier (TMA bytes) and an
//     "empty" one (one arrival per consumer warp); it gives its registers
//     away (setmaxnreg) to
//   * warpgroups 0 and 1, the consumers, 64 query rows each. For every kv
//     tile: S = Q.K^T by wgmma from shared memory into registers, the online
//     softmax in registers (row max and sum over the four threads of a row
//     by shuffles, exp2 with the scale folded into log2 units, the mask only
//     on tiles that cross the diagonal or the ragged end), then O += P.V by
//     wgmma with P, rounded to bf16, as the A operand straight from the S
//     registers and V read MN-major through the descriptor's transpose. The
//     O accumulator stays in registers until the epilogue divides by l.
// No product result ever goes through shared memory. The softmax is as
// costly as the products at D = 64 (one exp2 for every 128 multiply-adds),
// so it is hidden behind them twice over: inside a warpgroup, S of tile j
// and P.V of tile j-1 are started together and the softmax of tile j runs
// while P.V is on the tensor cores; and the two warpgroups take turns at
// starting their products (two named barriers), so that one's softmax runs
// while the other's products do. Tiles of 128 keys in 3 stages were
// measured fastest at the training shape (chip_smoke.py --tune; PERF.md).

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr float NEG_INF_SENTINEL = -1e30f;  // lse of a row that sees no key

template <int D, int BN, int STAGES>
struct FwdCfg {
  static constexpr int BM = 128;  // query rows per CTA, 64 per consumer warpgroup
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// The online softmax of one tile of scores, in place: s (raw Q.K^T of keys
// k0.. for the warpgroup's query rows qw0..) becomes P = 2^(s scale_log2 -
// m) under the mask, m and l (this thread's share of the row sum) move to
// the new tile, and alpha is the factor that rescales what came before.
// The mask is applied only on tiles that cross the diagonal or the end.
template <int NB>
__device__ __forceinline__ void softmax_tile(float (&s)[NB][32], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             int k0, int qw0, int skv, int q_off, int kv_off, int causal,
                                             float scale_log2) {
  constexpr int BN = NB * 64;
  const bool masked = k0 + BN > skv || (causal && (long long)kv_off + k0 + BN - 1 > (long long)q_off + qw0);
  const int row0 = qw0 + acc_row(0);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[nb][i] * scale_log2;
      if (masked) {
        const int kpos = k0 + 64 * nb + acc_col(i);
        const long long qpos = (long long)q_off + row0 + 8 * ((i / 2) % 2);
        if (kpos >= skv || (causal && qpos < (long long)kv_off + kpos)) x = -INFINITY;
      }
      s[nb][i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
  float mu[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mu[h] = mx[h] == -INFINITY ? 0.f : mx[h];  // nothing visible yet: every p is 0
    alpha[h] = fast_exp2(m[h] - mu[h]);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = fast_exp2(s[nb][i] - mu[(i / 2) % 2]);
      l[(i / 2) % 2] += p;
      s[nb][i] = p;
    }
}

template <int D, int BN, int STAGES>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, float* __restrict__ lse,
                          int sq, int skv, int d, int q_off, int kv_off, int causal, float scale_log2) {
  using C = FwdCfg<D, BN, STAGES>;
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
      mbar_expect_tx(qbar, C::Q_BYTES);
      tma_load_tile<C::BM, D>(smem + C::Q_OFF, &tq, qbar, q0, bh);
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
    const int qw0 = q0 + 64 * wg;  // this warpgroup's first query row
    const int row0 = qw0 + acc_row(0);  // this thread's rows: row0 and row0 + 8
    const unsigned char* sQ = smem + C::Q_OFF;

    float acc_o[DB][32];
#pragma unroll
    for (int b = 0; b < DB; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_o[b][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of scores, in log2 units
    float l[2] = {0.f, 0.f};              // this thread's share of the running sum
    float acc_s[NB][32];                  // scores of the tile in the softmax
    uint32_t pa[BN / 16][4];              // P of the tile whose P.V is next
    float alpha[2];

    // S_j = Q.K_j^T into acc_s (started, not waited for)
    auto start_s = [&](int j) {
      const unsigned char* sK = smem + C::K_OFF + (j % STAGES) * C::KV_BYTES;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0>(acc_s[nb], desc_k(sQ, C::BM, 64 * wg, kk), desc_k(sK, BN, 64 * nb, kk), kk > 0);
    };
    // O += P_j.V_j with P from pa (started, not waited for)
    auto start_pv = [&](int j) {
      const unsigned char* sV = smem + C::V_OFF + (j % STAGES) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int b = 0; b < DB; ++b) wgmma_rs<1>(acc_o[b], pa[kk], desc_mn(sV, BN, kk, b));
    };
    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(&empty[j % STAGES]);
    };
    // The two warpgroups take turns at starting their products (named
    // barriers 1 and 2), so that one's products run while the other's
    // softmax does: wait for this warpgroup's turn, then hand it over.
    auto my_turn = [&]() { named_sync(1 + wg, 256); };
    auto hand_over = [&]() { named_arrive(2 - wg, 256); };

    // The pipeline inside the warpgroup: while the softmax of tile j runs
    // on the CUDA cores, P_{j-1}.V_{j-1} runs on the tensor cores. Both
    // warpgroups walk all n_kv tiles of the CTA, so their turns pair up: a
    // tile past a warpgroup's last visible key is masked whole and adds
    // nothing (alpha 1, P 0).
    if (n_kv > 0) {
      if (wg == 1) hand_over();  // warpgroup 0 goes first
      mbar_wait(qbar, 0);
      mbar_wait(&full[0], 0);
      my_turn();
      wgmma_fence();
      start_s(0);
      wgmma_commit();
      hand_over();
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(acc_s[nb]);
      softmax_tile(acc_s, m, l, alpha, 0, qw0, skv, q_off, kv_off, causal, scale_log2);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) pack_a(pa[kk], acc_s[kk / 4], kk % 4);
      for (int j = 1; j < n_kv; ++j) {
        mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
#pragma unroll
        for (int b = 0; b < DB; ++b) fence_regs(acc_o[b]);
        my_turn();
        wgmma_fence();
        start_s(j);
        wgmma_commit();
        start_pv(j - 1);
        wgmma_commit();
        hand_over();
        wgmma_wait<1>();  // S_j is ready, P_{j-1}.V_{j-1} may still run
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) fence_regs(acc_s[nb]);
        softmax_tile(acc_s, m, l, alpha, j * BN, qw0, skv, q_off, kv_off, causal, scale_log2);
        wgmma_wait<0>();
#pragma unroll
        for (int b = 0; b < DB; ++b) fence_regs(acc_o[b]);
        release(j - 1);
#pragma unroll
        for (int b = 0; b < DB; ++b)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc_o[b][i] *= alpha[(i / 2) % 2];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) pack_a(pa[kk], acc_s[kk / 4], kk % 4);
      }
#pragma unroll
      for (int b = 0; b < DB; ++b) fence_regs(acc_o[b]);
      my_turn();
      wgmma_fence();
      start_pv(n_kv - 1);
      wgmma_commit();
      hand_over();
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < DB; ++b) fence_regs(acc_o[b]);
      release(n_kv - 1);
      if (wg == 0) my_turn();  // take warpgroup 1's last hand-over
    }

    // epilogue: the row sums over the quad, then o = acc / l and lse
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const size_t base = (size_t)bh * sq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
      const float div = l[h] == 0.f ? 1.f : l[h];
      bf16* orow = o + (base + row) * d;
#pragma unroll
      for (int b = 0; b < DB; ++b)
#pragma unroll
        for (int i = 2 * h; i < 32; i += 4) {  // registers i, i + 1 of row h
          const int col = 64 * b + acc_col(i);
          if (col < d)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(acc_o[b][i] / div, acc_o[b][i + 1] / div);
        }
      if (lane % 4 == 0) lse[base + row] = l[h] == 0.f ? NEG_INF_SENTINEL : m[h] * LN2 + logf(l[h]);
    }
  }
}

template <int D, int BN, int STAGES>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq, int skv, int d,
           int q_off, int kv_off, int causal, float scale, cudaStream_t stream) {
  using C = FwdCfg<D, BN, STAGES>;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, d, sq, bh, C::BM);
  if (e == 0) e = make_map(&tk, k, d, skv, bh, BN);
  if (e == 0) e = make_map(&tv, v, d, skv, bh, BN);
  if (e != 0) return e;
  auto kernel = flash_fwd_sm90_kernel<D, BN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(sq, C::BM), bh);
  kernel<<<grid, 384, C::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, sq, skv, d, q_off, kv_off, causal,
                                         scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Tile configurations: bn keys per kv tile (64 or 128) and stages (2 or 3).
// The default (0, 0) is the one measured fastest at the training shape:
// 128 keys, 3 stages. D = 128 takes 64 keys in 2 stages.
int hvd_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq, int skv,
                       int d, int q_off, int kv_off, int causal, float scale, int bn, int stages,
                       cudaStream_t stream) {
  if (d > 64) {
    if ((bn != 0 && bn != 64) || (stages != 0 && stages != 2)) return (int)cudaErrorInvalidValue;
    return launch<128, 64, 2>(q, k, v, o, lse, bh, sq, skv, d, q_off, kv_off, causal, scale, stream);
  }
  if (bn == 0) bn = 128;
  if (stages == 0) stages = 3;
#define HVD_FWD_CASE(BN_, ST_) \
  if (bn == BN_ && stages == ST_) return launch<64, BN_, ST_>(q, k, v, o, lse, bh, sq, skv, d, q_off, kv_off, causal, scale, stream);
  HVD_FWD_CASE(64, 2)
  HVD_FWD_CASE(64, 3)
  HVD_FWD_CASE(128, 2)
  HVD_FWD_CASE(128, 3)
#undef HVD_FWD_CASE
  return (int)cudaErrorInvalidValue;
}
