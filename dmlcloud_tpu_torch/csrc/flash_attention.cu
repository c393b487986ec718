// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV, hand-written CUDA C++.
//
// Replaces the three Pallas TPU kernels of dmlcloud_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _attn_kernel  (pallas_call in _flash_fwd_impl)
//   flash_bwd_dq_kernel  <- _dq_kernel    (first pallas_call in _flash_bwd_impl)
//   flash_bwd_dkv_kernel <- _dkv_kernel   (second pallas_call in _flash_bwd_impl)
//
// The contract is the reference's results, not its TPU block sizes:
//   q [B, T, H, D], k/v [B, S, KH, D] (contiguous), H % KH == 0 (GQA: query head
//   h reads KV head h / (H / KH)); operands in their own dtype (fp32 or bf16),
//   every product accumulated in fp32; causal is top-left (q_pos >= k_pos); a
//   window keeps q_pos - k_pos < W (W may be <= 0 without causal: the ring's
//   shifted hops); segment ids [B, T] int32 mask pairs across segments; rows and
//   columns past T / S are masked in the kernel, so any length is accepted; a row
//   with nothing to attend to writes out = 0 and lse = -1e30 + log(1e-30).
//   lse and delta are fp32 [B*H, T] (the reference's kernel residual layout).
//
// What bounds them on the H100: at the training shapes (T = S = 2048, D = 128)
// attention does ~4*T*S*D/2 multiply-adds per head against ~3*T*D*2 bytes of
// operands, far above the card's ~295 FLOP/byte ridge: they are bound by
// arithmetic. This first version does the arithmetic on the CUDA cores in fp32
// (67 TFLOP/s peak, not the 989 of the bf16 tensor cores), so its ceiling is the
// fp32 FMA rate and shared-memory bandwidth. What the design does about it:
//   - each thread block owns one 64-row tile and streams 64-row tiles of the
//     other operand through shared memory (the loop in the block replaces the
//     TPU's sequential grid axis; m, l and the accumulators stay in registers);
//   - every thread computes an RPT x 4 sub-tile of the score block and an
//     RPT x D/16 sub-tile of the output from 2-element smem loads (~64 FMA per
//     12 loads), with padded row strides so the loads are free of bank conflicts;
//   - whole tiles past the diagonal or outside the window are skipped by the
//     loop bounds (the reference's _kv_skip_cond / _q_skip_cond), and the causal
//     grid is walked heaviest tile first so the last wave is short;
//   - K3 owns one (batch, KV head, K tile) and loops over the group's query heads,
//     so the GQA sum happens in registers and dk/dv are written once, in place.
// For bf16 operands with head dim 64 or 128, all three run on the tensor cores
// instead (flash_attention_tc.cu: wgmma, TMA, warp specialisation); these
// kernels take fp32 and the other head dims.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value (_NEG_INF)
constexpr int kBlock = 64;         // rows of every Q and K/V tile
constexpr int kPStride = kBlock + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Round through T: the reference casts p and ds to the operand dtype before
// their products (`p.astype(v.dtype)`, `ds.astype(k.dtype)`).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

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

// Stage a kBlock x D_PAD tile: dst[r][d] = src[(row0 + r) * row_stride + d],
// zero outside rows [row0, nrows) and columns [0, D). Zero fill matters: a
// masked p of 0 times uninitialised V could be NaN.
template <typename T, int D_PAD, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int nrows, size_t row_stride,
                                          int D, int tid) {
  constexpr int STR = D_PAD + 2;
  for (int idx = tid; idx < kBlock * D_PAD; idx += NT) {
    const int r = idx / D_PAD, d = idx % D_PAD;
    const int gr = row0 + r;
    T val = from_f<T>(0.f);
    if (gr < nrows && d < D) val = src[(size_t)gr * row_stride + d];
    dst[r * STR + d] = val;
  }
}

// acc[i][j] = sum_d A[ty + NTY*i][d] * B[tx + 16*j][d] over two smem tiles.
template <typename T, int RPT, int CPT, int NTY, int D_PAD>
__device__ __forceinline__ void tile_dot(const T* A, const T* Bm, int ty, int tx, float (&acc)[RPT][CPT]) {
  constexpr int STR = D_PAD + 2;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D_PAD; d += 2) {
    float2 a[RPT], b[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = load2(A + (ty + NTY * i) * STR + d);
#pragma unroll
    for (int j = 0; j < CPT; ++j) b[j] = load2(Bm + (tx + 16 * j) * STR + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
      }
  }
}

// acc[i][j] += sum_c P[ty + NTY*i][c] * V[c][tx + 16*j]; P is an fp32 smem tile.
template <typename T, int RPT, int DPT, int NTY, int D_PAD>
__device__ __forceinline__ void tile_pv(const float* P, const T* V, int ty, int tx, float (&acc)[RPT][DPT]) {
  constexpr int STR = D_PAD + 2;
#pragma unroll 4
  for (int c = 0; c < kBlock; ++c) {
    float p[RPT], v[DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) p[i] = P[(ty + NTY * i) * kPStride + c];
#pragma unroll
    for (int j = 0; j < DPT; ++j) v[j] = to_f(V[c * STR + tx + 16 * j]);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
  }
}

// The reference's participation mask for one (query, key) pair.
__device__ __forceinline__ bool keep_pair(const Params& p, int qp, int kp, int sq, int sk) {
  bool ok = qp < p.T && kp < p.S;
  if (p.causal) ok = ok && qp >= kp;
  if (p.has_window) ok = ok && (qp - kp) < p.window;
  if (p.seg) ok = ok && sq == sk;
  return ok;
}

// K-tile range [lo, hi) a query tile [q0, q0 + kBlock) can reach (the loop
// bounds that replace _kv_skip_cond); empty when lo >= hi.
__device__ __forceinline__ void kv_tile_range(const Params& p, int q0, int& lo, int& hi) {
  long long k_lo = 0, k_hi = p.S;
  if (p.causal) k_hi = k_hi < (long long)q0 + kBlock ? k_hi : (long long)q0 + kBlock;
  if (p.has_window) {
    long long w_lo = (long long)q0 - p.window + 1;
    k_lo = w_lo > 0 ? w_lo : 0;
  }
  if (k_lo >= k_hi) {
    lo = hi = 0;
    return;
  }
  lo = (int)(k_lo / kBlock);
  hi = (int)((k_hi + kBlock - 1) / kBlock);
}

// ---------------------------------------------------------------------------
// K1: forward. One block per (batch * head, query tile); K/V tiles stream.
//
// Replaces _attn_kernel (dmlcloud_tpu/ops/flash_attention.py:149, launched at
// :773). Bound on the H100: operations -- 4*D multiply-adds' worth of FLOPs
// per unmasked (query, key) pair (68.7 GFLOP per layer at B=4, H=16, T=2048,
// D=128, causal) against ~101 MB of q/k/v/out/lse. The design keeps the score
// tile and the running (m, l, acc) out of device memory (the flash property),
// skips tiles past the diagonal or the window by loop bounds, and walks the
// causal grid heaviest tile first; the products still run on fp32 CUDA cores.
// ---------------------------------------------------------------------------
template <typename T, int D_PAD>
__global__ void __launch_bounds__(128) flash_fwd_kernel(Params p) {
  constexpr int NTY = 8, NT = 128, RPT = kBlock / NTY, CPT = kBlock / 16, DPT = D_PAD / 16;
  constexpr int STR = D_PAD + 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBlock * STR;
  T* Vs = Ks + kBlock * STR;
  float* Ps = reinterpret_cast<float*>(Vs + kBlock * STR);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, kh = h / (p.H / p.KH);
  const int q0 = qb * kBlock;
  const T* qbase = static_cast<const T*>(p.q) + ((size_t)b * p.T * p.H + h) * p.D;
  const T* kbase = static_cast<const T*>(p.k) + ((size_t)b * p.S * p.KH + kh) * p.D;
  const T* vbase = static_cast<const T*>(p.v) + ((size_t)b * p.S * p.KH + kh) * p.D;

  load_tile<T, D_PAD, NT>(Qs, qbase, q0, p.T, (size_t)p.H * p.D, p.D, tid);

  float m[RPT], l[RPT], acc[RPT][DPT];
  int segq[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty + NTY * i;
    m[i] = kNegInf;
    l[i] = 0.f;
    segq[i] = (p.seg && qp < p.T) ? p.seg[(size_t)b * p.T + qp] : 0;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int kb_lo, kb_hi;
  kv_tile_range(p, q0, kb_lo, kb_hi);
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // readers of the previous K/V/P tiles are done
    load_tile<T, D_PAD, NT>(Ks, kbase, k0, p.S, (size_t)p.KH * p.D, p.D, tid);
    load_tile<T, D_PAD, NT>(Vs, vbase, k0, p.S, (size_t)p.KH * p.D, p.D, tid);
    __syncthreads();

    float s[RPT][CPT];
    tile_dot<T, RPT, CPT, NTY, D_PAD>(Qs, Ks, ty, tx, s);
    int segk[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kp = k0 + tx + 16 * j;
      segk[j] = (p.seg && kp < p.S) ? p.seg[(size_t)b * p.T + kp] : 0;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty + NTY * i;
      float bm = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k0 + tx + 16 * j;
        s[i][j] = keep_pair(p, qp, kp, segq[i], segk[j]) ? s[i][j] * p.scale : kNegInf;
        bm = fmaxf(bm, s[i][j]);
      }
      bm = row_max16(bm);
      const float new_m = fmaxf(m[i], bm);
      const float corr = expf(m[i] - new_m);
      // a row fully masked in this tile keeps p == 0 (the reference's dead-row rule)
      const bool live = bm > kNegInf / 2;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pv = live ? expf(s[i][j] - new_m) : 0.f;
        rs += pv;
        Ps[(ty + NTY * i) * kPStride + tx + 16 * j] = round_to<T>(pv);
      }
      rs = row_sum16(rs);
      l[i] = l[i] * corr + rs;
      m[i] = new_m;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    tile_pv<T, RPT, DPT, NTY, D_PAD>(Ps, Vs, ty, tx, acc);
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty + NTY * i;
    if (qp >= p.T) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* orow = out + (((size_t)b * p.T + qp) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) orow[d] = from_f<T>(acc[i][j] / ls);
    }
    if (tx == 0 && p.lse_out) p.lse_out[(size_t)bh * p.T + qp] = m[i] + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// K2: dQ. Same grid as the forward; K/V tiles stream, dq accumulates in registers.
//
// Replaces _dq_kernel (dmlcloud_tpu/ops/flash_attention.py:229, launched at
// :847). Bound on the H100: operations -- three products per tile (Q K^T,
// dO V^T, dS K; 103 GFLOP per layer at the 1b training shapes). The design
// recomputes p = exp(s - lse) from the saved statistics (never a forward
// replay), takes delta = rowsum(dO * O) precomputed outside like the
// reference, keeps dq in registers across the K/V loop and writes it once.
// It takes fp32, and bf16 with head dim 16 or 32; bf16 with head dim 64 or
// 128 goes to flash_bwd_dq_tc_kernel (flash_attention_tc.cu).
// ---------------------------------------------------------------------------
template <typename T, int D_PAD>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(Params p) {
  constexpr int NTY = 8, NT = 128, RPT = kBlock / NTY, CPT = kBlock / 16, DPT = D_PAD / 16;
  constexpr int STR = D_PAD + 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBlock * STR;
  T* Ks = dOs + kBlock * STR;
  T* Vs = Ks + kBlock * STR;
  float* DSs = reinterpret_cast<float*>(Vs + kBlock * STR);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, kh = h / (p.H / p.KH);
  const int q0 = qb * kBlock;
  const size_t qoff = ((size_t)b * p.T * p.H + h) * p.D;
  const T* kbase = static_cast<const T*>(p.k) + ((size_t)b * p.S * p.KH + kh) * p.D;
  const T* vbase = static_cast<const T*>(p.v) + ((size_t)b * p.S * p.KH + kh) * p.D;

  load_tile<T, D_PAD, NT>(Qs, static_cast<const T*>(p.q) + qoff, q0, p.T, (size_t)p.H * p.D, p.D, tid);
  load_tile<T, D_PAD, NT>(dOs, static_cast<const T*>(p.dout) + qoff, q0, p.T, (size_t)p.H * p.D, p.D, tid);

  float lse[RPT], delta[RPT], acc[RPT][DPT];
  int segq[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty + NTY * i;
    const bool in = qp < p.T;
    lse[i] = in ? p.lse[(size_t)bh * p.T + qp] : 0.f;
    delta[i] = in ? p.delta[(size_t)bh * p.T + qp] : 0.f;
    segq[i] = (p.seg && in) ? p.seg[(size_t)b * p.T + qp] : 0;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int kb_lo, kb_hi;
  kv_tile_range(p, q0, kb_lo, kb_hi);
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();
    load_tile<T, D_PAD, NT>(Ks, kbase, k0, p.S, (size_t)p.KH * p.D, p.D, tid);
    load_tile<T, D_PAD, NT>(Vs, vbase, k0, p.S, (size_t)p.KH * p.D, p.D, tid);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
    tile_dot<T, RPT, CPT, NTY, D_PAD>(Qs, Ks, ty, tx, s);
    tile_dot<T, RPT, CPT, NTY, D_PAD>(dOs, Vs, ty, tx, dp);
    int segk[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kp = k0 + tx + 16 * j;
      segk[j] = (p.seg && kp < p.S) ? p.seg[(size_t)b * p.T + kp] : 0;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty + NTY * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k0 + tx + 16 * j;
        // masked pairs contribute exactly 0 (also on rows with nothing to attend to)
        const float pr = keep_pair(p, qp, kp, segq[i], segk[j]) ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        DSs[(ty + NTY * i) * kPStride + tx + 16 * j] = round_to<T>(pr * (dp[i][j] - delta[i]) * p.scale);
      }
    }
    __syncthreads();
    tile_pv<T, RPT, DPT, NTY, D_PAD>(DSs, Ks, ty, tx, acc);
  }

  T* dq = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty + NTY * i;
    if (qp >= p.T) continue;
    T* row = dq + (((size_t)b * p.T + qp) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) row[d] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dK/dV. One block per (batch * KV head, K tile); the group's query heads
// and their Q/dO tiles stream through it. Rows of the thread tile are keys.
//
// Replaces _dkv_kernel (dmlcloud_tpu/ops/flash_attention.py:276, launched at
// :883). Bound on the H100: operations -- four products per tile (Q K^T,
// dO V^T, P^T dO, dS^T Q; 137 GFLOP per layer at the 1b training shapes). Where the
// TPU kernel writes per-query-head fp32 dk/dv and sums the GQA group after
// the kernel (:901-903), this block loops over the group's query heads itself:
// the sum stays in registers and dk/dv are written once, in [B, S, KH, D] and
// the operand dtype, with no fp32 [B*H, S, D] intermediates in device memory.
// ---------------------------------------------------------------------------
template <typename T, int D_PAD>
__global__ void __launch_bounds__(256) flash_bwd_dkv_kernel(Params p) {
  constexpr int NTY = 16, NT = 256, RPT = kBlock / NTY, CPT = kBlock / 16, DPT = D_PAD / 16;
  constexpr int STR = D_PAD + 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBlock * STR;
  T* Qs = Vs + kBlock * STR;
  T* dOs = Qs + kBlock * STR;
  float* Ps = reinterpret_cast<float*>(dOs + kBlock * STR);
  float* DSs = Ps + kBlock * kPStride;
  float* lse_s = DSs + kBlock * kPStride;
  float* delta_s = lse_s + kBlock;
  int* segq_s = reinterpret_cast<int*>(delta_s + kBlock);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kb = blockIdx.x;
  const int bkh = blockIdx.y, b = bkh / p.KH, kh = bkh % p.KH;
  const int group = p.H / p.KH;
  const int k0 = kb * kBlock;
  const size_t kvoff = ((size_t)b * p.S * p.KH + kh) * p.D;

  load_tile<T, D_PAD, NT>(Ks, static_cast<const T*>(p.k) + kvoff, k0, p.S, (size_t)p.KH * p.D, p.D, tid);
  load_tile<T, D_PAD, NT>(Vs, static_cast<const T*>(p.v) + kvoff, k0, p.S, (size_t)p.KH * p.D, p.D, tid);

  float dk[RPT][DPT], dv[RPT][DPT];
  int segk[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kp = k0 + ty + NTY * i;
    segk[i] = (p.seg && kp < p.S) ? p.seg[(size_t)b * p.T + kp] : 0;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  // Q-tile range this K tile can be reached from (the loop bounds that
  // replace _q_skip_cond): causal drops queries before k0, a window drops
  // queries past k_last + W - 1.
  long long q_lo = 0, q_hi = p.T;
  if (p.causal) q_lo = k0;
  if (p.has_window) {
    const long long w_hi = (long long)k0 + kBlock + p.window - 1;
    q_hi = q_hi < w_hi ? q_hi : w_hi;
  }
  const int qb_lo = (int)(q_lo / kBlock);
  const int qb_hi = q_lo < q_hi ? (int)((q_hi + kBlock - 1) / kBlock) : qb_lo;

  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g, bh = b * p.H + h;
    const size_t qoff = ((size_t)b * p.T * p.H + h) * p.D;
    for (int qb = qb_lo; qb < qb_hi; ++qb) {
      const int q0 = qb * kBlock;
      __syncthreads();
      load_tile<T, D_PAD, NT>(Qs, static_cast<const T*>(p.q) + qoff, q0, p.T, (size_t)p.H * p.D, p.D, tid);
      load_tile<T, D_PAD, NT>(dOs, static_cast<const T*>(p.dout) + qoff, q0, p.T, (size_t)p.H * p.D, p.D, tid);
      if (tid < kBlock) {
        const int qp = q0 + tid;
        const bool in = qp < p.T;
        lse_s[tid] = in ? p.lse[(size_t)bh * p.T + qp] : 0.f;
        delta_s[tid] = in ? p.delta[(size_t)bh * p.T + qp] : 0.f;
        segq_s[tid] = (p.seg && in) ? p.seg[(size_t)b * p.T + qp] : 0;
      }
      __syncthreads();

      float s[RPT][CPT], dp[RPT][CPT];
      tile_dot<T, RPT, CPT, NTY, D_PAD>(Ks, Qs, ty, tx, s);   // s[i][j] = k_i . q_j
      tile_dot<T, RPT, CPT, NTY, D_PAD>(Vs, dOs, ty, tx, dp); // dp[i][j] = v_i . do_j
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int c = ty + NTY * i, kp = k0 + c;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int r = tx + 16 * j, qp = q0 + r;
          const float pr =
              keep_pair(p, qp, kp, segq_s[r], segk[i]) ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
          Ps[c * kPStride + r] = round_to<T>(pr);
          DSs[c * kPStride + r] = round_to<T>(pr * (dp[i][j] - delta_s[r]) * p.scale);
        }
      }
      __syncthreads();
      tile_pv<T, RPT, DPT, NTY, D_PAD>(Ps, dOs, ty, tx, dv);   // dv += p^T . dO
      tile_pv<T, RPT, DPT, NTY, D_PAD>(DSs, Qs, ty, tx, dk);   // dk += ds^T . Q
    }
  }

  T* dk_out = static_cast<T*>(p.out);
  T* dv_out = static_cast<T*>(p.out2);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kp = k0 + ty + NTY * i;
    if (kp >= p.S) continue;
    const size_t row = (((size_t)b * p.S + kp) * p.KH + kh) * p.D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) {
        dk_out[row + d] = from_f<T>(dk[i][j]);
        dv_out[row + d] = from_f<T>(dv[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D_PAD>
cudaError_t launch(int kind, const Params& p, cudaStream_t stream) {
  constexpr size_t tile = (size_t)kBlock * (D_PAD + 2) * sizeof(T);
  constexpr size_t ptile = (size_t)kBlock * kPStride * sizeof(float);
  size_t smem;
  void (*kern)(Params);
  dim3 grid;
  int threads;
  if (kind == kFwd) {
    smem = 3 * tile + ptile;
    kern = flash_fwd_kernel<T, D_PAD>;
    grid = dim3((p.T + kBlock - 1) / kBlock, p.B * p.H);
    threads = 128;
  } else if (kind == kDq) {
    smem = 4 * tile + ptile;
    kern = flash_bwd_dq_kernel<T, D_PAD>;
    grid = dim3((p.T + kBlock - 1) / kBlock, p.B * p.H);
    threads = 128;
  } else {
    smem = 4 * tile + 2 * ptile + 3 * kBlock * sizeof(float);
    kern = flash_bwd_dkv_kernel<T, D_PAD>;
    grid = dim3((p.S + kBlock - 1) / kBlock, p.B * p.KH);
    threads = 256;
  }
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int kind, const Params& p, cudaStream_t stream) {
  if (p.D <= 16) return launch<T, 16>(kind, p, stream);
  if (p.D <= 32) return launch<T, 32>(kind, p, stream);
  if (p.D <= 64) return launch<T, 64>(kind, p, stream);
  if (p.D <= 128) return launch<T, 128>(kind, p, stream);
  return cudaErrorInvalidValue;
}

int run(int kind, int dtype, const Params& p, void* stream) {
  if (p.H <= 0 || p.KH <= 0 || p.H % p.KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(kind, p, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(kind, p, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
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

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launch.
extern "C" int dml_flash_fwd(int dtype, const void* q, const void* k, const void* v, const int* seg, void* out,
                             float* lse, int B, int T, int S, int H, int KH, int D, float scale, int causal,
                             int has_window, int window, void* stream) {
  Params p = make_params(q, k, v, seg, B, T, S, H, KH, D, scale, causal, has_window, window);
  p.out = out;
  p.lse_out = lse;
  return run(kFwd, dtype, p, stream);
}

extern "C" int dml_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, const int* seg, void* dq, int B, int T,
                                int S, int H, int KH, int D, float scale, int causal, int has_window, int window,
                                void* stream) {
  Params p = make_params(q, k, v, seg, B, T, S, H, KH, D, scale, causal, has_window, window);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out = dq;
  return run(kDq, dtype, p, stream);
}

extern "C" int dml_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, const int* seg, void* dk, void* dv, int B,
                                 int T, int S, int H, int KH, int D, float scale, int causal, int has_window,
                                 int window, void* stream) {
  Params p = make_params(q, k, v, seg, B, T, S, H, KH, D, scale, causal, has_window, window);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.out = dk;
  p.out2 = dv;
  return run(kDkv, dtype, p, stream);
}
