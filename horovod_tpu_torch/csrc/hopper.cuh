// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// mbarriers, TMA tile loads, wgmma with shared-memory descriptors or a
// register A operand, the accumulator fragment layout, register
// rebalancing, and the host-side tensor-map encoder.
//
// Shared-memory tiles. Every bf16 tile is stored as blocks of [rows][64]
// elements, one 128-byte row per tile row, in TMA's 128-byte swizzle; each
// block starts on a 1024-byte boundary. A tile of head dim D has D / 64 such
// blocks, `rows * 128` bytes apart. TMA writes them from a 3-D tensor map
// (D, S, BH) whose box is 64 columns wide, so columns past the tensor's d
// and rows past its S arrive as zeros, never as the next head's rows.
//
// wgmma operands (PTX ISA, "Matrix Descriptor"; CuTe's GmmaDescriptor):
//   * K-major (the contracted dimension contiguous: Q and K in Q.K^T, K and
//     V as A of K.Q^T and V.dO^T, Q and dO as B there): 8 rows of 128 bytes
//     form one swizzle atom, SBO = 1024 bytes to the next 8 rows; a 16-wide
//     k step moves the start address by 32 bytes inside the atom.
//   * MN-major (the output dimension contiguous: V in P.V, dO and Q in
//     P^T.dO and dS^T.Q), transpose flag 1: 8 k-rows of 128 bytes form an
//     atom, SBO = 1024 bytes to the next 8 k-rows, LBO to the next 64-wide
//     block of the output dimension; a 16-deep k step moves 2048 bytes.
//
// Accumulator layout of an m64nN fp32 wgmma: thread t of the warpgroup (warp
// w = t / 32, lane l) holds register i at
//   row = 16 w + l / 4 + 8 ((i / 2) % 2),  col = 8 (i / 4) + 2 (l % 4) + i % 2.
// Registers 8c..8c+7 of an accumulator are exactly the A fragment of the
// 16-wide k chunk c of the next product, so a score tile becomes the A
// operand of P.V without leaving registers (pack_a).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, rounded up to the 1024-byte boundary that
// 128-byte swizzled tiles need (the launch asks for 1024 bytes more).
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// 2^34 cycles (about ten seconds) can only be a broken pipeline: it traps,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// ---- named barriers (id 0 is __syncthreads) --------------------------------

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A [ROWS x D] tile, rows row0.. of head bh, as D / 64 swizzled blocks.
template <int ROWS, int D>
__device__ __forceinline__ void tma_load_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int row0,
                                              int bh) {
#pragma unroll
  for (int b = 0; b < D / 64; ++b) tma_load_3d(dst + b * ROWS * 128, map, bar, 64 * b, row0, bh);
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulator registers across the
// asynchronous wgmma boundary (CuTe's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}

// A K-major operand: rows row0.. and the 16-wide k chunk kk of a tile of
// `rows` rows.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int rows, int row0, int kk) {
  return desc_sw128(tile + (kk / 4) * rows * 128 + row0 * 128 + (kk % 4) * 32, 16, 1024);
}

// An MN-major operand: k rows 16 kk.. and the 64-wide output block nb of a
// tile of `rows` (k) rows.
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int rows, int kk, int nb) {
  return desc_sw128(tile + nb * rows * 128 + kk * 16 * 128, rows * 128, 1024);
}

#define HVD_ACC16(d)                                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

#define HVD_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

#define HVD_ACC32(d)                                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),            \
      "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),            \
      "+f"(d[30]), "+f"(d[31])

#define HVD_D32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both operands in shared memory;
// A K-major, B K-major (TRANS_B 0) or MN-major (1). scale_d 0 overwrites d.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_D32 ", %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : HVD_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// The same for a 64 x 32 tile of d (m64n32k16).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HVD_D16 ", %16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : HVD_ACC16(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64] with A in registers (pack_a).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : HVD_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
}

#undef HVD_ACC16
#undef HVD_D16
#undef HVD_ACC32
#undef HVD_D32

// 2^x in one instruction (MUFU.EX2); results below 2^-126 flush to 0, which
// no sum of probabilities can see.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k chunk c (columns 16c..16c+15) of an fp32 accumulator
// (N / 2 registers for N columns), rounded to bf16.
template <int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&acc)[R], int c) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_bf16(acc[8 * c + 2 * r], acc[8 * c + 2 * r + 1]);
}

// Row (0..63) and column (0..63) of accumulator register i for this thread.
__device__ __forceinline__ int acc_row(int i) { return (threadIdx.x % 128) / 32 * 16 + (threadIdx.x % 32) / 4 + 8 * ((i / 2) % 2); }
__device__ __forceinline__ int acc_col(int i) { return 8 * (i / 4) + 2 * (threadIdx.x % 4) + (i % 2); }

// ---- register rebalancing between warpgroups -------------------------------

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- causal ranges (all the flash kernels, fp32 ones included) --------------

// Number of kv tiles of `bn` keys that query rows [q0, q_end) can see (all
// when !causal).
__device__ __forceinline__ int kv_tiles(int q0, int q_end, int skv, int q_off, int kv_off, int causal, int bn) {
  const int n = cdiv(skv, bn);
  if (!causal) return n;
  const long long last = (long long)q_off + q_end - 1 - kv_off;  // last visible key position
  return last < 0 ? 0 : (int)min((long long)n, last / bn + 1);
}

// First q tile of `bq` rows whose last row reaches key row k0 (0 when
// !causal; n_q when none does).
__device__ __forceinline__ int first_q_tile(int k0, int n_q, int q_off, int kv_off, int causal, int bq) {
  if (!causal) return 0;
  const long long x = (long long)kv_off + k0 - q_off - (bq - 1);
  return x <= 0 ? 0 : (int)min((long long)n_q, (x + bq - 1) / bq);
}

// ---- host: tensor maps -----------------------------------------------------

// A 3-D map over a contiguous bf16 [bh, s, d] tensor, innermost first
// (d, s, bh), read in boxes of 64 columns x box_rows rows with 128-byte
// swizzle and zero fill outside the tensor. Returns a cudaError_t code.
inline int make_map(CUtensorMap* map, const void* ptr, int d, int s, int bh, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                                     &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper

// Launchers of the sm_90a bf16 kernels (flash_fwd_sm90.cu, flash_dq_sm90.cu,
// flash_dkv_sm90.cu), called by the C entry points in flash_attention.cu and,
// to compare tile configurations, through ctypes. `bn` (K1's and K2's keys
// per kv tile) and `stages` pick the tiles; 0 takes the default. Each returns
// the CUDA error code of the launch.
extern "C" {
int hvd_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq, int skv,
                       int d, int q_off, int kv_off, int causal, float scale, int bn, int stages,
                       cudaStream_t stream);
int hvd_flash_dq_sm90(const void* q, const void* k, const void* v, const void* g, const float* lse,
                      const float* delta, void* dq, int out_f32, int bh, int sq, int skv, int d, int q_off,
                      int kv_off, int causal, float scale, int bn, int stages, cudaStream_t stream);
int hvd_flash_dkv_sm90(const void* q, const void* k, const void* v, const void* g, const float* lse,
                       const float* delta, void* dk, void* dv, int out_f32, int bh, int sq, int skv, int d, int q_off,
                       int kv_off, int causal, float scale, int stages, cudaStream_t stream);
}
