// Flash attention on Hopper's bf16 tensor cores (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of dmlcloud_tpu/ops/flash_attention.py
// for bf16 operands with head dim 64 or 128 (flash_attention.cu keeps fp32 and
// the other head dims):
//   flash_fwd_tc_kernel     <- _attn_kernel (:149, pallas_call :773 in _flash_fwd_impl)
//   flash_bwd_dq_tc_kernel  <- _dq_kernel   (:229, pallas_call :847 in _flash_bwd_impl)
//   flash_bwd_dkv_tc_kernel <- _dkv_kernel  (:276, pallas_call :883 in _flash_bwd_impl)
//
// The contract is flash_attention.cu's, unchanged: q [B, T, H, D], k/v
// [B, S, KH, D] contiguous, GQA (query head h reads KV head h / (H / KH)),
// top-left causal, windows q_pos - k_pos < W (W <= 0 allowed without causal),
// segment ids [B, T], any T and S with the ragged edge masked in the kernel,
// dead rows write out = 0 and lse = -1e30 + log(1e-30), masked pairs give
// exactly p = 0 in the backward, lse and delta fp32 [B*H, T], and dk/dv summed
// over the GQA group in the kernel and written once in [B, S, KH, D]. The
// reference's rounding points stay where the tensor cores take their operands:
// p is rounded to bf16 for P.V with l summed from the unrounded p (:197-206);
// ds is rounded to bf16 for dS.K (:264); p and ds are rounded to bf16 for
// P^T.dO and dS^T.Q (:310-318).
//
// What bounds them on the H100: at the training shapes (T = S = 2048, D = 128,
// causal) attention does ~4*D FLOPs per unmasked pair and product pair against
// a few bytes per row, ~1000 FLOP/byte, far above the 295 FLOP/byte ridge of
// the bf16 tensor cores: they are bound by tensor-core operations (989 TFLOP/s
// dense bf16). What the design does about it:
//   - every product is a warpgroup MMA (wgmma.mma_async, m64nNk16, fp32
//     accumulators in registers). K1: S = Q.K^T with both operands in shared
//     memory (K [kv, d] is already the K-major B operand); O += P.V with P as
//     the register A operand, converted to bf16 in place from the S
//     accumulator (the accumulator and A-fragment layouts coincide), and V the
//     MN-major B operand read through wgmma's transpose bit. K2 takes K1's
//     products: S = Q.K^T and dP = dO.V^T from shared memory, p recomputed
//     from lse, then dQ += dS.K with dS as the register A operand and the same
//     K tile as the MN-major B operand. K3 works with keys as rows:
//     S^T = K.Q^T and dP^T = V.dO^T from shared memory, P^T recomputed from
//     lse (broadcast along the columns), then dV += P^T.dO and dK += dS^T.Q
//     with P^T and dS^T as register A operands;
//   - warp specialisation: a block is two consumer warpgroups and a producer
//     warp; the producer gives its registers up (setmaxnreg 24) so that the
//     consumers can hold their accumulators (setmaxnreg 240) without spilling;
//   - tiles arrive by TMA (cp.async.bulk.tensor, 4-D maps over [B, rows,
//     heads, D], so rows past T or S are zero-filled by the hardware) into
//     rings with full/empty mbarriers (two stages; three for K2's smaller
//     tiles): the next K and V tiles (K1, K2) or Q/dO tile (K3) load while the
//     current one is multiplied; K1 releases a K stage as soon as S is
//     computed, a V stage when P.V is, and K2 a V stage when dP is, a K stage
//     when dS.K is. Shared-memory tiles use the 128-byte swizzle that TMA writes and wgmma
//     reads without bank conflicts (a D = 128 tile is two 64-column halves);
//   - K1 overlaps its softmax with the tensor cores twice: within a
//     warpgroup, S of tile j and P.V of tile j - 1 are issued together and
//     the softmax of tile j runs under the P.V product; between the two
//     warpgroups, named barriers make them take turns issuing (ping-pong).
//     K2 overlaps the same way within a warpgroup (S and dP of tile j with
//     dS.K of tile j - 1), and its two warpgroups without turns;
//   - the causal / window / segment / ragged-edge mask is applied only on tiles
//     that it cuts, as a column range per row (and a segment-id compare on
//     packed rows, the ids staged in shared memory by the producer); tiles
//     wholly outside are skipped by the loop bounds, and the tile index is the
//     slow grid axis, walked so that the heaviest causal tiles start first;
//   - tile sizes: K1 takes 128 query rows per block (64 per consumer
//     warpgroup) and 128-key tiles; K2 the same rows and 64-key tiles, so that
//     dQ (64 x D fp32 per warpgroup), S, dP and the dS fragments fit in 240
//     registers; K3 takes 128 keys per block (64 per warpgroup), loops over
//     the group's query heads and the reachable 64-row query tiles, and keeps dK and dV (2 x 64 x D fp32 per warpgroup) in
//     registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value (_NEG_INF)
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // backward only
  const float* lse;   // backward input
  const float* delta; // backward input
  const int* seg;     // [B, T] or null
  void* out;          // forward: out; dq kernel: dq; dkv kernel: dk
  void* out2;         // dkv kernel: dv
  float* lse_out;     // forward: lse or null
  int B, T, S, H, KH, D;
  float scale;
  int causal, has_window, window;
};

// ---------------------------------------------------------------------------
// PTX primitives: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map {d, head, row, batch} into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled bf16 tile: rows of
// 128 bytes (64 columns), 8-row groups 1024 bytes apart (SBO). `lbo` is the
// distance between 64-column halves, read only for MN-major operands wider
// than 64.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma (its results exist only after the wait), and register A
// operands alive until the wgmma that reads them is done.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int KS>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU instruction (exp2f adds a slow path for denormal results,
// which the softmax does not need and which costs the forward much of its
// time).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d[32] += A (smem, K-major) * B (smem, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A (registers, 4 x bf16x2) * B (smem, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (smem, K-major) * B (smem, K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64] += A (registers, 4 x bf16x2) * B (smem, MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ int seg_at(const Params& p, int b, int pos, int len) {
  return (p.seg && pos < len) ? __ldg(p.seg + (size_t)b * p.T + pos) : 0;
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* ptr) {
  const uint32_t a = smem_u32(ptr);
  return ptr + (((a + 1023u) & ~1023u) - a);
}

// Element i of an m64nN fp32 accumulator (or of its bf16 A fragments) sits in
// row lane / 4 + 8 * ((i >> 1) & 1) of the warp's 16 rows, column
// (i / 4) * 8 + 2 * (lane % 4) + (i & 1).
__device__ __forceinline__ int acc_col(int i, int lane) { return (i / 4) * 8 + 2 * (lane % 4) + (i & 1); }

// bf16 A fragments of an m64 x (16 * KS) operand from the fp32 accumulator
// that holds it (the layouts coincide: k-step kk is n8 chunks 2kk and 2kk+1).
template <int KS>
__device__ __forceinline__ void acc_to_a(const float (&acc)[KS * 8], uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// The K and V rings of K1 and K2, filled by the producer warp: K tile j of
// [lo, lo + n) (BN keys, D = 64 NH columns, with the keys' segment ids) into
// stage j % NS on k_full, the V tile on v_full, each stage refilled once both
// consumer warpgroups have released it.
template <int BN, int NS, int NH>
__device__ __forceinline__ void produce_kv(const CUtensorMap* tk, const CUtensorMap* tv, const Params& p,
                                           uint8_t* sK, uint8_t* sV, int* sSeg, uint64_t* k_full,
                                           uint64_t* k_empty, uint64_t* v_full, uint64_t* v_empty, int b, int kh,
                                           int lo, int n, int lane) {
  constexpr uint32_t KV_BYTES = BN * NH * 64 * 2;
  for (int j = 0; j < n; ++j) {
    const int s = j % NS, k0 = (lo + j) * BN;
    if (j >= NS) mbar_wait(&k_empty[s], (j / NS - 1) & 1);
    if (p.seg)
      for (int c = lane; c < BN; c += 32) sSeg[s * BN + c] = seg_at(p, b, k0 + c, p.S);
    if (lane == 0) {
      mbar_expect_tx(&k_full[s], KV_BYTES);
#pragma unroll
      for (int c = 0; c < NH; ++c) tma_load(sK + s * KV_BYTES + c * BN * 128, tk, &k_full[s], c * 64, kh, k0, b);
      if (j >= NS) mbar_wait(&v_empty[s], (j / NS - 1) & 1);
      mbar_expect_tx(&v_full[s], KV_BYTES);
#pragma unroll
      for (int c = 0; c < NH; ++c) tma_load(sV + s * KV_BYTES + c * BN * 128, tv, &v_full[s], c * 64, kh, k0, b);
    } else {
      mbar_arrive(&k_full[s]);
    }
  }
}

// ---------------------------------------------------------------------------
// K1: forward. One block of 384 threads per (batch * head, 128 query rows):
// warpgroups 0 and 1 own rows 64w..64w+63 and compute; the first warp of
// warpgroup 2 is the producer, which keeps two rings filled by TMA, one of
// 128-key K tiles (with the keys' segment ids) and one of V tiles, each
// stage released as soon as its product is done. A consumer issues
// S = Q K_j^T and O += P_{j-1} V_{j-1} together and runs the softmax of tile
// j while the P.V product is still in flight; the two consumers take turns
// issuing.
// ---------------------------------------------------------------------------
constexpr int kFwdBM = 128, kFwdBN = 128, kFwdStages = 2;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return (size_t)kFwdBM * D * 2 + 2 * kFwdStages * (size_t)kFwdBN * D * 2 + kFwdStages * kFwdBN * sizeof(int) +
         (1 + 4 * kFwdStages) * sizeof(uint64_t) + 1024;
}

// S = Q K^T for one warpgroup's 64 rows: both operands K-major in shared
// memory, D / 16 k-steps; issued, not waited for.
template <int D, int BM, int BN>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], const uint8_t* sQ, const uint8_t* sK, int wg) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(sc, smem_desc(sQ + (kk / 4) * BM * 128 + wg * 64 * 128 + (kk % 4) * 32, 16),
             smem_desc(sK + (kk / 4) * BN * 128 + (kk % 4) * 32, 16), kk > 0);
  wgmma_commit();
}

// O += P V: P the register A operand, V [BN, D] the MN-major B operand.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4], const uint8_t* sV) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(o, pa[kk], smem_desc(sV + kk * 16 * 128, BN * 128));
  wgmma_commit();
}

// One tile of raw scores: on a tile the mask cuts, masked pairs set to
// -1e30 (`seg_k` holds the tile's key segment ids). Then the online-softmax
// update of (m, l) for the thread's two rows, m kept on the raw scores and
// sm_scale folded into the exponent: sc becomes the unrounded p, corr the
// factor the accumulator has to be rescaled by. l is summed per thread and
// reduced over the row's four threads once, at the end.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
                                             const Params& p, bool cut, int row0, int k0, const int* seg_k,
                                             const int (&segq)[2], int lane) {
  const float scale_log2 = p.scale * kLog2e;
  if (cut) {
    // row r keeps the tile's columns [c_lo, c_hi) (causal, window, ragged
    // edges) and, on packed rows, only its own segment's
    int c_lo[2], c_hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      c_hi[r] = (qp >= p.T ? 0 : p.causal && qp + 1 < p.S ? qp + 1 : p.S) - k0;
      c_lo[r] = (p.has_window ? qp - p.window + 1 : 0) - k0;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = acc_col(i, lane), r = (i >> 1) & 1;
      bool keep = col >= c_lo[r] && col < c_hi[r];
      if (p.seg) keep = keep && seg_k[col] == segq[r];
      if (!keep) sc[i] = kNegInf;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) mx = fmaxf(mx, fmaxf(sc[c * 4 + 2 * r], sc[c * 4 + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float new_m = fmaxf(m[r], mx);
    corr[r] = fast_exp2((m[r] - new_m) * scale_log2);
    // a row fully masked in this tile keeps p == 0 (the reference's dead-row
    // rule): an infinite offset sends every exponent to -inf
    const float mb = mx > kNegInf / 2 ? new_m * scale_log2 : INFINITY;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = c * 4 + 2 * r + e;
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -mb));
        rs += sc[i];
      }
    l[r] = l[r] * corr[r] + rs;
    m[r] = new_m;
  }
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int BM = kFwdBM, BN = kFwdBN, NH = D / 64, NS = kFwdStages;
  constexpr uint32_t Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sK = sQ + Q_BYTES;         // stage s at sK + s KV_BYTES
  uint8_t* sV = sK + NS * KV_BYTES;   // stage s at sV + s KV_BYTES
  int* sSeg = reinterpret_cast<int*>(sV + NS * KV_BYTES);  // stage s: segment ids of K stage s [BN]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sSeg + NS * BN);
  uint64_t* k_full = q_full + 1;      // [s]: K stage s (and its segment ids) arrived
  uint64_t* k_empty = k_full + NS;    // [s]: both consumer warpgroups are done with K stage s
  uint64_t* v_full = k_empty + NS;
  uint64_t* v_empty = v_full + NS;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // the query tile is the slow grid axis, walked from the last: the
  // heaviest causal tiles of every head start first
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, kh = h / (p.H / p.KH);
  const int q0 = qb * BM;

  // K-tile range [lo, lo + n) the query rows can reach (_kv_skip_cond as loop bounds)
  long long k_lo = 0, k_hi = p.S;
  if (p.causal) k_hi = k_hi < (long long)q0 + BM ? k_hi : (long long)q0 + BM;
  if (p.has_window && (long long)q0 - p.window + 1 > 0) k_lo = (long long)q0 - p.window + 1;
  const int lo = (int)(k_lo / BN);
  const int n = k_lo < k_hi ? (int)((k_hi + BN - 1) / BN) - lo : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&k_full[s], 32);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 256);
      mbar_init(&v_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: the first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 0 && n > 0) {
      if (lane == 0) {
        mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
        for (int c = 0; c < NH; ++c) tma_load(sQ + c * BM * 128, &tq, q_full, c * 64, h, q0, b);
      }
      produce_kv<BN, NS, NH>(&tk, &tv, p, sK, sV, sSeg, k_full, k_empty, v_full, v_empty, b, kh, lo, n, lane);
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
    const int segq[2] = {seg_at(p, b, row0, p.T), seg_at(p, b, row0 + 8, p.T)};
    float o[D / 2], sc[BN / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    auto cut = [&](int k0) {  // does the mask cut the tile at k0?
      return p.seg || q0 + BM > p.T || k0 + BN > p.S || (p.causal && k0 + BN - 1 > q0) ||
             (p.has_window && q0 + BM - 1 - k0 >= p.window);
    };

    // ping-pong: the two warpgroups take turns issuing their products (named
    // barrier 1 + w is warpgroup w's turn), so one's softmax runs under the
    // other's products. Warpgroup 0 goes first; warpgroup 1 skips its last
    // hand-over, so every barrier phase completes.
    auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
    auto your_turn = [&](bool last) {
      if (!(last && wg == 1)) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    };
    if (n > 0 && wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    if (n > 0) {
      mbar_wait(q_full, 0);
      mbar_wait(&k_full[0], 0);
      my_turn();
      issue_qk<D, BM, BN>(sc, sQ, sK, wg);
      your_turn(false);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile<BN>(sc, m, l, corr, p, cut(lo * BN), row0, lo * BN, sSeg, segq, lane);
      mbar_arrive(&k_empty[0]);
      acc_to_a<BN / 16>(sc, pa);
    }
    for (int j = 1; j < n; ++j) {
      const int s = j % NS, sp = (j - 1) % NS, k0 = (lo + j) * BN;
      mbar_wait(&k_full[s], (j / NS) & 1);
      mbar_wait(&v_full[sp], ((j - 1) / NS) & 1);
      my_turn();
      issue_qk<D, BM, BN>(sc, sQ, sK + s * KV_BYTES, wg);
      issue_pv<D, BN>(o, pa, sV + sp * KV_BYTES);
      your_turn(false);
      wgmma_wait<1>();  // S of tile j; P.V of tile j - 1 still runs
      fence_regs(sc);
      softmax_tile<BN>(sc, m, l, corr, p, cut(k0), row0, k0, sSeg + s * BN, segq, lane);
      mbar_arrive(&k_empty[s]);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&v_empty[sp]);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[c * 4] *= corr[0];
        o[c * 4 + 1] *= corr[0];
        o[c * 4 + 2] *= corr[1];
        o[c * 4 + 3] *= corr[1];
      }
      acc_to_a<BN / 16>(sc, pa);  // P rounded to bf16 (p.astype(v.dtype))
    }
    if (n > 0) {
      const int sp = (n - 1) % NS;
      mbar_wait(&v_full[sp], ((n - 1) / NS) & 1);
      my_turn();
      issue_pv<D, BN>(o, pa, sV + sp * KV_BYTES);
      your_turn(true);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lsum = l[r];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const float ls = fmaxf(lsum, 1e-30f);
      const int qp = row0 + 8 * r;
      if (qp >= p.T) continue;
      __nv_bfloat16* orow = out + (((size_t)b * p.T + qp) * p.H + h) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + c * 8 + 2 * (lane % 4)) =
            pack_bf16(o[c * 4 + 2 * r] / ls, o[c * 4 + 2 * r + 1] / ls);
      // m is on the raw scores; a dead row keeps the reference's -1e30 + log(1e-30)
      const float m_nat = m[r] > kNegInf / 2 ? m[r] * p.scale : kNegInf;
      if (lane % 4 == 0 && p.lse_out) p.lse_out[(size_t)bh * p.T + qp] = m_nat + logf(ls);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dQ. K1's block: 384 threads per (batch * head, 128 query rows),
// warpgroups 0 and 1 own rows 64w..64w+63, the first warp of warpgroup 2 is
// the producer. It loads the Q and dO tiles once and keeps two rings filled
// by TMA: 64-key K tiles (with the keys' segment ids) and V tiles. Per tile a
// consumer computes S = Q K^T and dP = dO V^T, then p = exp(s - lse) from the
// saved statistics and dS = p (dP - delta) scale, and issues dQ += dS K (dS
// the register A operand, K the MN-major B operand: the K tile serves both
// products). S and dP of tile j are issued together with dS K of tile j - 1,
// so the dS of tile j is computed under that product. dQ stays in registers
// across the tiles and is written once.
// ---------------------------------------------------------------------------
constexpr int kDqBM = 128, kDqBN = 64, kDqStages = 3;

template <int D>
constexpr size_t dq_smem_bytes() {
  return 2 * (size_t)kDqBM * D * 2 + 2 * kDqStages * (size_t)kDqBN * D * 2 + kDqStages * kDqBN * sizeof(int) +
         (1 + 4 * kDqStages) * sizeof(uint64_t) + 1024;
}

// dS = p (dP - delta) scale for one tile, in place of dP, with
// p = exp2(s * scale * log2(e) - lse * log2(e)). A pair the mask drops gets
// p = 0 by a select, never by a product: on a dead row (lse = -1e30 + log(1e-30))
// the exponent is +inf. Only tiles the mask cuts test the pairs.
template <int BN>
__device__ __forceinline__ void dq_ds_tile(const float (&sc)[BN / 2], float (&dp)[BN / 2], const Params& p, bool cut,
                                           int row0, int k0, const int* seg_k, const int (&segq)[2],
                                           const float (&lse2)[2], const float (&delta)[2], int lane) {
  const float scale_log2 = p.scale * kLog2e;
  int c_lo[2] = {0, 0}, c_hi[2] = {BN, BN};
  if (cut) {
    // row r keeps the tile's columns [c_lo, c_hi) (causal, window, ragged edges)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      c_hi[r] = (qp >= p.T ? 0 : p.causal && qp + 1 < p.S ? qp + 1 : p.S) - k0;
      c_lo[r] = (p.has_window ? qp - p.window + 1 : 0) - k0;
    }
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int col = acc_col(i, lane), r = (i >> 1) & 1;
    float pr = fast_exp2(fmaf(sc[i], scale_log2, -lse2[r]));
    if (cut && (col < c_lo[r] || col >= c_hi[r] || (p.seg && seg_k[col] != segq[r]))) pr = 0.f;
    dp[i] = pr * (dp[i] - delta[r]) * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                           const Params p) {
  constexpr int BM = kDqBM, BN = kDqBN, NH = D / 64, NS = kDqStages;
  constexpr uint32_t Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sdO = sQ + Q_BYTES;
  uint8_t* sK = sdO + Q_BYTES;        // stage s at sK + s KV_BYTES
  uint8_t* sV = sK + NS * KV_BYTES;   // stage s at sV + s KV_BYTES
  int* sSeg = reinterpret_cast<int*>(sV + NS * KV_BYTES);  // stage s: segment ids of K stage s [BN]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sSeg + NS * BN);  // Q and dO arrived
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + NS;    // [s]: both consumer warpgroups are done with K stage s
  uint64_t* v_full = k_empty + NS;
  uint64_t* v_empty = v_full + NS;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // the query tile is the slow grid axis, walked from the last: the
  // heaviest causal tiles of every head start first
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, kh = h / (p.H / p.KH);
  const int q0 = qb * BM;

  // K-tile range [lo, lo + n) the query rows can reach (_kv_skip_cond as
  // loop bounds). Both warpgroups walk all of it: bounds that depend on the
  // warpgroup would put the wgmma issue on a path the compiler takes as
  // divergent, and it then serializes every wgmma.
  long long k_lo = 0, k_hi = p.S;
  if (p.causal) k_hi = k_hi < (long long)q0 + BM ? k_hi : (long long)q0 + BM;
  if (p.has_window && (long long)q0 - p.window + 1 > 0) k_lo = (long long)q0 - p.window + 1;
  const int lo = (int)(k_lo / BN);
  const int n = k_lo < k_hi ? (int)((k_hi + BN - 1) / BN) - lo : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&k_full[s], 32);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 256);
      mbar_init(&v_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: the first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 0 && n > 0) {
      if (lane == 0) {
        mbar_expect_tx(q_full, 2 * Q_BYTES);
#pragma unroll
        for (int c = 0; c < NH; ++c) {
          tma_load(sQ + c * BM * 128, &tq, q_full, c * 64, h, q0, b);
          tma_load(sdO + c * BM * 128, &tdo, q_full, c * 64, h, q0, b);
        }
      }
      produce_kv<BN, NS, NH>(&tk, &tv, p, sK, sV, sSeg, k_full, k_empty, v_full, v_empty, b, kh, lo, n, lane);
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int qw = q0 + wg * 64;                        // this warpgroup's first row
    const int row0 = qw + warp * 16 + lane / 4;         // this thread's rows: row0, row0 + 8
    const int segq[2] = {seg_at(p, b, row0, p.T), seg_at(p, b, row0 + 8, p.T)};
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      lse2[r] = qp < p.T ? p.lse[(size_t)bh * p.T + qp] * kLog2e : 0.f;
      delta[r] = qp < p.T ? p.delta[(size_t)bh * p.T + qp] : 0.f;
    }
    // does the mask cut the tile at k0 for this warpgroup's rows? (a tile
    // wholly outside them is cut too, and every tile of a window <= 0: the
    // ring's shifted hops, which make dead rows)
    auto cut = [&](int k0) {
      return p.seg || qw + 64 > p.T || k0 + BN > p.S || (p.causal && k0 + BN - 1 > qw) ||
             (p.has_window && (p.window <= 0 || qw + 63 - k0 >= p.window));
    };

    float dq[D / 2], sc[BN / 2], dp[BN / 2];
    uint32_t dsa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    // S and dP of tile j are issued together with dS K of tile j - 1; the dS
    // of tile j is computed while dS K of tile j - 1 still runs
    if (n > 0) {
      mbar_wait(q_full, 0);
      mbar_wait(&k_full[0], 0);
      mbar_wait(&v_full[0], 0);
      issue_qk<D, BM, BN>(sc, sQ, sK, wg);
      issue_qk<D, BM, BN>(dp, sdO, sV, wg);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(&v_empty[0]);
      dq_ds_tile<BN>(sc, dp, p, cut(lo * BN), row0, lo * BN, sSeg, segq, lse2, delta, lane);
      acc_to_a<BN / 16>(dp, dsa);  // dS rounded to bf16 (ds.astype(k.dtype))
    }
    for (int j = 1; j < n; ++j) {
      const int s = j % NS, sp = (j - 1) % NS, k0 = (lo + j) * BN;
      mbar_wait(&k_full[s], (j / NS) & 1);
      mbar_wait(&v_full[s], (j / NS) & 1);
      issue_qk<D, BM, BN>(sc, sQ, sK + s * KV_BYTES, wg);
      issue_qk<D, BM, BN>(dp, sdO, sV + s * KV_BYTES, wg);
      issue_pv<D, BN>(dq, dsa, sK + sp * KV_BYTES);
      wgmma_wait<1>();  // S and dP of tile j; dS K of tile j - 1 still runs
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(&v_empty[s]);
      dq_ds_tile<BN>(sc, dp, p, cut(k0), row0, k0, sSeg + s * BN, segq, lse2, delta, lane);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dsa);
      mbar_arrive(&k_empty[sp]);
      acc_to_a<BN / 16>(dp, dsa);
    }
    if (n > 0) {
      const int sp = (n - 1) % NS;
      issue_pv<D, BN>(dq, dsa, sK + sp * KV_BYTES);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dsa);
      mbar_arrive(&k_empty[sp]);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      if (qp >= p.T) continue;
      __nv_bfloat16* orow = out + (((size_t)b * p.T + qp) * p.H + h) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + c * 8 + 2 * (lane % 4)) = pack_bf16(dq[c * 4 + 2 * r], dq[c * 4 + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dK/dV. One block of 384 threads per (batch * KV head, 128 keys):
// warpgroups 0 and 1 own keys 64w..64w+63 as accumulator rows and compute;
// a warp of warpgroup 2 is the producer, which streams the group's query
// heads and their reachable 64-row Q/dO tiles (with their lse, delta and
// segment ids) through the ring. dK and dV stay in registers across all of them (the GQA
// sum) and are written once.
// ---------------------------------------------------------------------------
constexpr int kBwdBK = 128, kBwdBQ = 64, kBwdStages = 2;

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 2 * (size_t)kBwdBK * D * 2 + kBwdStages * (2 * (size_t)kBwdBQ * D * 2 + 3 * kBwdBQ * sizeof(float)) +
         (1 + 2 * kBwdStages) * sizeof(uint64_t) + 1024;
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                            const Params p) {
  constexpr int BK = kBwdBK, BQ = kBwdBQ, NH = D / 64, NS = kBwdStages;
  constexpr uint32_t KV_BYTES = BK * D * 2, Q_BYTES = BQ * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align_1024(smem_raw);
  uint8_t* sV = sK + KV_BYTES;
  uint8_t* sQ = sV + KV_BYTES;  // stage s: Q at sQ + 2 s Q_BYTES, dO right after
  // stage s: lse * log2(e) [BQ], delta [BQ], and the rows' segment ids [BQ]
  float* stats = reinterpret_cast<float*>(sQ + 2 * NS * Q_BYTES);
  int* sSeg = reinterpret_cast<int*>(stats + 2 * NS * BQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sSeg + NS * BQ);
  uint64_t* full = kv_full + 1;  // [s]: Q/dO and the statistics of stage s arrived
  uint64_t* empty = full + NS;   // [s]: both consumer warpgroups are done with stage s

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // the K tile is the slow grid axis: causal, the first K tiles of every head
  // are reached by the most queries and start first
  const int kb = blockIdx.y;
  const int bkh = blockIdx.x, b = bkh / p.KH, kh = bkh % p.KH;
  const int group = p.H / p.KH;
  const int k0 = kb * BK;

  // Q-tile range this K tile can be reached from (_q_skip_cond as loop
  // bounds): causal drops queries before k0, a window queries past
  // k_last + W - 1.
  long long q_lo = 0, q_hi = p.T;
  if (p.causal) q_lo = k0;
  if (p.has_window) {
    const long long w_hi = (long long)k0 + BK + p.window - 1;
    q_hi = q_hi < w_hi ? q_hi : w_hi;
  }
  const int qb_lo = (int)(q_lo / BQ);
  const int nq = q_lo < q_hi ? (int)((q_hi + BQ - 1) / BQ) - qb_lo : 0;
  const int n = group * nq;  // work items: (query head of the group, query tile)

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: the first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 0 && n > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * KV_BYTES);
#pragma unroll
        for (int c = 0; c < NH; ++c) {
          tma_load(sK + c * BK * 128, &tk, kv_full, c * 64, kh, k0, b);
          tma_load(sV + c * BK * 128, &tv, kv_full, c * 64, kh, k0, b);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % NS, h = kh * group + i / nq, q0 = (qb_lo + i % nq) * BQ;
        if (i >= NS) mbar_wait(&empty[s], (i / NS - 1) & 1);
        // lse (in log2 units) and delta of the tile's rows
        const size_t row0 = (size_t)(b * p.H + h) * p.T;
        float* st = stats + 2 * BQ * s;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < p.T;
          st[r] = in ? p.lse[row0 + q0 + r] * kLog2e : 0.f;
          st[BQ + r] = in ? p.delta[row0 + q0 + r] : 0.f;
          if (p.seg) sSeg[s * BQ + r] = seg_at(p, b, q0 + r, p.T);
        }
        if (lane == 0) {
          uint8_t* dq = sQ + 2 * s * Q_BYTES;
          mbar_expect_tx(&full[s], 2 * Q_BYTES);
#pragma unroll
          for (int c = 0; c < NH; ++c) {
            tma_load(dq + c * BQ * 128, &tq, &full[s], c * 64, h, q0, b);
            tma_load(dq + Q_BYTES + c * BQ * 128, &tdo, &full[s], c * 64, h, q0, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int key0 = k0 + wg * 64 + warp * 16 + lane / 4;  // this thread's keys: key0, key0 + 8
    const int segk[2] = {seg_at(p, b, key0, p.S), seg_at(p, b, key0 + 8, p.S)};
    const float scale_log2 = p.scale * kLog2e;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n > 0) mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % NS, q0 = (qb_lo + i % nq) * BQ;
      const uint8_t* sQi = sQ + 2 * s * Q_BYTES;
      const uint8_t* sdOi = sQi + Q_BYTES;
      const float* st = stats + 2 * BQ * s;
      mbar_wait(&full[s], (i / NS) & 1);

      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys
      float sT[BQ / 2], dpT[BQ / 2];
      fence_regs(sT);
      fence_regs(dpT);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int koff = (kk / 4) * BK * 128 + wg * 64 * 128 + (kk % 4) * 32;
        const int qoff = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        wgmma_ss(sT, smem_desc(sK + koff, 16), smem_desc(sQi + qoff, 16), kk > 0);
        wgmma_ss(dpT, smem_desc(sV + koff, 16), smem_desc(sdOi + qoff, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);

      // P^T from lse (masked pairs exactly 0) and dS^T = P^T (dP^T - delta) scale
      // key row r keeps the tile's query columns [c_lo, c_hi) (causal,
      // window, ragged edges) and, on packed rows, only its own segment's
      const bool cut = p.seg || q0 + BQ > p.T || k0 + BK > p.S || (p.causal && q0 < k0 + BK - 1) ||
                       (p.has_window && q0 + BQ - 1 - k0 >= p.window);
      int c_lo[2] = {0, 0}, c_hi[2] = {BQ, BQ};
      if (cut) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kp = key0 + 8 * r;
          c_lo[r] = (p.causal ? kp : 0) - q0;
          c_hi[r] = (kp >= p.S ? 0 : p.has_window && kp + p.window < p.T ? kp + p.window : p.T) - q0;
        }
      }
      const int* seg_q = sSeg + s * BQ;
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int col = acc_col(j, lane), r = (j >> 1) & 1;
        float pr = fast_exp2(fmaf(sT[j], scale_log2, -st[col]));
        if (cut && (col < c_lo[r] || col >= c_hi[r] || (p.seg && seg_q[col] != segk[r]))) pr = 0.f;
        sT[j] = pr;
        dpT[j] = pr * (dpT[j] - st[BQ + col]) * p.scale;
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16
      // (p.astype(do.dtype), ds.astype(q.dtype)) as register A operands
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
      acc_to_a<BQ / 16>(sT, pa);
      acc_to_a<BQ / 16>(dpT, dsa);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs(dv, pa[kk], smem_desc(sdOi + kk * 16 * 128, BQ * 128));
        wgmma_rs(dk, dsa[kk], smem_desc(sQi + kk * 16 * 128, BQ * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.out);
    __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.out2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = key0 + 8 * r;
      if (kp >= p.S) continue;
      const size_t row = (((size_t)b * p.S + kp) * p.KH + kh) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int col = c * 8 + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(dk_out + row + col) = pack_bf16(dk[c * 4 + 2 * r], dk[c * 4 + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv_out + row + col) = pack_bf16(dv[c * 4 + 2 * r], dv[c * 4 + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// 4-D map {d, head, row, batch} over a contiguous bf16 [batch, rows, heads, D]
// tensor; a box is 64 columns x box_rows rows of one head, 128-byte swizzled.
// Rows past `rows` read as zeros.
bool make_map(CUtensorMap* map, const void* base, int batch, int rows, int heads, int D, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t e = 2;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)batch};
  cuuint64_t strides[3] = {D * e, (cuuint64_t)heads * D * e, (cuuint64_t)rows * heads * D * e};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.T + kFwdBM - 1) / kFwdBM);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, p.B, p.T, p.H, D, kFwdBM) || !make_map(&tk, p.k, p.B, p.S, p.KH, D, kFwdBN) ||
      !make_map(&tv, p.v, p.B, p.S, p.KH, D, kFwdBN))
    return cudaErrorInvalidValue;
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_tc_kernel<D><<<grid, 384, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.B * p.H, (p.T + kDqBM - 1) / kDqBM);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, p.q, p.B, p.T, p.H, D, kDqBM) || !make_map(&tdo, p.dout, p.B, p.T, p.H, D, kDqBM) ||
      !make_map(&tk, p.k, p.B, p.S, p.KH, D, kDqBN) || !make_map(&tv, p.v, p.B, p.S, p.KH, D, kDqBN))
    return cudaErrorInvalidValue;
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc_kernel<D><<<grid, 384, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.B * p.KH, (p.S + kBwdBK - 1) / kBwdBK);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, p.q, p.B, p.T, p.H, D, kBwdBQ) || !make_map(&tdo, p.dout, p.B, p.T, p.H, D, kBwdBQ) ||
      !make_map(&tk, p.k, p.B, p.S, p.KH, D, kBwdBK) || !make_map(&tv, p.v, p.B, p.S, p.KH, D, kBwdBK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tc_kernel<D><<<grid, 384, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

bool valid(const Params& p) {
  return p.H > 0 && p.KH > 0 && p.H % p.KH == 0 && (p.D == 64 || p.D == 128);
}

Params make_params(const void* q, const void* k, const void* v, const int* seg, int B, int T, int S, int H,
                   int KH, int D, float scale, int causal, int has_window, int window) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = seg;
  p.B = B;
  p.T = T;
  p.S = S;
  p.H = H;
  p.KH = KH;
  p.D = D;
  p.scale = scale;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  return p;
}

}  // namespace

// bf16 operands, D = 64 or 128. Each returns the cudaError_t of its launch.
extern "C" int dml_flash_fwd_tc(const void* q, const void* k, const void* v, const int* seg, void* out, float* lse,
                                int B, int T, int S, int H, int KH, int D, float scale, int causal, int has_window,
                                int window, void* stream) {
  Params p = make_params(q, k, v, seg, B, T, S, H, KH, D, scale, causal, has_window, window);
  p.out = out;
  p.lse_out = lse;
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? launch_fwd<64>(p, s) : launch_fwd<128>(p, s));
}

extern "C" int dml_flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                   const float* delta, const int* seg, void* dq, int B, int T, int S, int H, int KH,
                                   int D, float scale, int causal, int has_window, int window, void* stream) {
  Params p = make_params(q, k, v, seg, B, T, S, H, KH, D, scale, causal, has_window, window);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out = dq;
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? launch_dq<64>(p, s) : launch_dq<128>(p, s));
}

extern "C" int dml_flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                    const float* delta, const int* seg, void* dk, void* dv, int B, int T, int S,
                                    int H, int KH, int D, float scale, int causal, int has_window, int window,
                                    void* stream) {
  Params p = make_params(q, k, v, seg, B, T, S, H, KH, D, scale, causal, has_window, window);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out = dk;
  p.out2 = dv;
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? launch_dkv<64>(p, s) : launch_dkv<128>(p, s));
}
