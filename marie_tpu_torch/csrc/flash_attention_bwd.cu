// The gradient of K2: dq, dk and dv of o = softmax(q k^T * scale + masks) v
// for float32 q [B,H,Sq,D] and k/v [B,H,Skv,D], D in {32, 64}, given the
// output's gradient do and each row's log-sum-exp lse [B*H, Sq] that the
// training forward (flash_attention.cu, mt_flash_attention_lse) writes.
// Operands are given by pointer and (batch, head, row) strides in
// elements, the last dimension contiguous, as in the forward.
//
// Replaces the gradient JAX takes of marie_tpu/ops/pallas/flash_attention.py
// (flash_attention): the JAX package has no backward Pallas kernel, and at
// these head widths it differentiates _attention_reference, the plain
// softmax, with autograd.  This kernel computes that same function:
//   P  = exp(S * scale - lse_i), S = q k^T, masked pairs 0; a fully masked
//        row (kv_len 0, or causal rows above the diagonal when Sq > Skv)
//        averages V, so its P is 1/Skv on every key;
//   dv = P^T do;  dP = do v^T;  Di = sum_j P_ij dP_ij;
//   dS = P * (dP - Di) on the pairs the masks leave, else 0 (the masks'
//        where() passes no gradient to masked logits), so a fully masked
//        row gives q and k nothing;
//   dq = dS k * scale;  dk = dS^T q * scale.
//
// Why each row's lse and Di are recomputed here.  The forward's S comes
// from 3xTF32 products and its O from a TF32-split P, so P = exp(S * scale -
// lse) recomputed in float32 does not sum to 1, nor does rowsum(do * o)
// equal sum_j P dP, to float32 precision (~1e-6).  A row of dS then fails
// to sum to 0 by that much, and where the keys are nearly equal (the
// reading-order ranker's boxes) dq = sum_j dS_ij k_j cancels down to the
// error: on an H100 the ranker's q/k weight gradients came out 4.2e-4 of
// their largest off the CPU's with Di = rowsum(do * o).  So the
// dq pass first sums, per row, p = exp(S * scale - lse) (the forward's lse
// keeps it in range) and p dP: the row's own lse is lse + log(sum p) and
// Di = sum(p dP) / sum(p), and the rows of P it forms sum to 1 and those
// of dS to 0 within float32 rounding, as autograd's softmax gradient does.
//
// Two launches, float32 FMAs on the CUDA cores (no tensor cores):
//   * dq_kernel: one block of 128 threads per (b, h, 32 query rows).  It
//     stages the rows' Q and do, then walks the key tiles its rows see
//     twice: pass 1 recomputes S and dP (each thread 2x4 of the 32x32
//     tile) and sums the rows' p and p dP (written to `stats` for the dk/dv
//     pass); pass 2 recomputes them, forms P and dS * scale in shared
//     memory and accumulates dq += dS k in registers (each thread 4 rows x
//     D/16 columns).
//   * dkdv_kernel: one block per (b, h, 32 keys).  It keeps its K and V
//     tile in shared memory and walks the query tiles: stage Q, do and the
//     rows' lse and Di; recompute S and dP, form P and dS; accumulate dv +=
//     P^T do and dk += dS^T q.  Query tiles none of whose rows sees a key
//     of this tile, and that hold no fully masked row, are skipped: past a
//     page's kv_len only fully masked rows reach dv.
// S and dP are computed three times (twice in the dq pass), and nothing
// runs on the tensor cores: this is the simple first kernel; tensor cores
// and one fused pass are follow-ups (ROADMAP §2).
//
// What bounds it on this card: its own operations on the CUDA cores.  Per
// seen (query, key) pair the gradient needs 10 D flops (S and dP
// recomputed, dV, dK, dQ); this kernel does 14 D, as float32 FMAs, while
// the bytes (q, k, v, do read, dq, dk, dv written) take a few microseconds
// at the trainers' shapes.  Shared-memory rows are padded to D+1 floats so
// the 8 key rows a warp reads at one column fall in distinct banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 32;  // query rows and keys of a tile

struct BwdStrides {  // in elements; rows of D values are contiguous
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, db, dh, ds, dqb, dqh, dqs, dkb, dkh, dks,
      dvb, dvh, dvs;
};

struct Masks {
  int kvl, shift, causal, Sq, Skv;
  // row qi sees keys [0, lim(qi)); lim never falls as qi grows
  __device__ __forceinline__ int lim(int qi) const {
    return causal ? min(kvl, max(0, qi + shift + 1)) : kvl;
  }
};

__device__ __forceinline__ Masks make_masks(const int32_t* kv_len, int b, int Sq, int Skv,
                                            int causal) {
  Masks m;
  m.kvl = kv_len ? max(0, min(kv_len[b], Skv)) : Skv;
  m.shift = Skv - Sq;
  m.causal = causal;
  m.Sq = Sq;
  m.Skv = Skv;
  return m;
}

// rows [r0, r0 + kT) of a row-strided [*, D] operand into shared rows of
// D + 1 floats; rows at or past `valid` are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride,
                                          int r0, int valid) {
  for (int e = threadIdx.x; e < kT * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r0 + r < valid ? src[(long long)(r0 + r) * stride + c] : 0.0f;
  }
}

// acc[r][c] = sum_d A[ra(r)][d] * B[cb(c)][d] over a 32x32 tile: this
// thread's rows 2*ti + r and columns tj + 8c
template <int D>
__device__ __forceinline__ void tile_product(const float* A, const float* Bm, int ti, int tj,
                                             float (&acc)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float a0 = A[(2 * ti) * (D + 1) + d], a1 = A[(2 * ti + 1) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float bv = Bm[(tj + 8 * c) * (D + 1) + d];
      acc[0][c] = fmaf(a0, bv, acc[0][c]);
      acc[1][c] = fmaf(a1, bv, acc[1][c]);
    }
  }
}

// P and dS * scale of one 32x32 tile (queries i0.., keys j0..) from S and
// dP, into sP and sdS ([query][key], rows of kT + 1)
__device__ __forceinline__ void form_p_ds(const float (&s)[2][4], const float (&dp)[2][4],
                                          const float* sLse, const float* sDi, int ti, int tj,
                                          int i0, int j0, const Masks& m, float scale,
                                          float* sP, float* sdS) {
  const float uniform = 1.0f / (float)m.Skv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int li = 2 * ti + r, i = i0 + li;
    const int lim = m.lim(i);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int lj = tj + 8 * c, j = j0 + lj;
      float p = 0.0f, ds = 0.0f;
      if (i < m.Sq && j < m.Skv) {
        if (lim == 0) {
          p = uniform;
        } else if (j < lim) {
          p = expf(fmaf(s[r][c], scale, -sLse[li]));
          ds = p * (dp[r][c] - sDi[li]) * scale;
        }
      }
      sP[li * (kT + 1) + lj] = p;
      sdS[li * (kT + 1) + lj] = ds;
    }
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 4 * kT * (D + 1) + 2 * kT * (kT + 1) + 2 * kT;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            const int32_t* __restrict__ kv_len, float* __restrict__ dk,
            float* __restrict__ dv, BwdStrides st, int H, int Sq, int Skv, int k_blocks,
            float scale, int causal) {
  constexpr int kE = D / 16;  // output columns of a thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kT * (D + 1);
  float* sQ = sV + kT * (D + 1);
  float* sdO = sQ + kT * (D + 1);
  float* sP = sdO + kT * (D + 1);
  float* sdS = sP + kT * (kT + 1);
  float* sLse = sdS + kT * (kT + 1);
  float* sDi = sLse + kT;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / k_blocks;
  const int b = bh / H, h = bh % H;
  const int j0 = (blockIdx.x % k_blocks) * kT;
  const Masks m = make_masks(kv_len, b, Sq, Skv, causal);
  const float* qg = q + b * st.qb + h * st.qh;
  const float* dg = dout + b * st.db + h * st.dh;
  const float* lg = lse + (long long)bh * Sq;
  const float* dig = di + (long long)bh * Sq;

  load_tile<D>(sK, k + b * st.kb + h * st.kh, st.ks, j0, Skv);
  load_tile<D>(sV, v + b * st.vb + h * st.vh, st.vs, j0, Skv);

  const int ti = tid >> 3, tj = tid & 7;    // S tile: rows 2ti+r, keys tj+8c
  const int jr = tid >> 4, dc = tid & 15;   // outputs: keys jr+8a, columns dc+16e
  float acc_k[4][kE], acc_v[4][kE];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc_k[a][e] = acc_v[a][e] = 0.0f;

  for (int i0 = 0; i0 < Sq; i0 += kT) {
    const int i_last = min(i0 + kT, Sq) - 1;
    // a row of the tile sees key j0, or a row is fully masked
    if (!(m.lim(i_last) > j0 || m.lim(i0) == 0)) continue;
    __syncthreads();  // the previous tile's sQ, sdO, sP and sdS are consumed
    load_tile<D>(sQ, qg, st.qs, i0, Sq);
    load_tile<D>(sdO, dg, st.ds, i0, Sq);
    if (tid < kT) {
      sLse[tid] = i0 + tid < Sq ? lg[i0 + tid] : 0.0f;
      sDi[tid] = i0 + tid < Sq ? dig[i0 + tid] : 0.0f;
    }
    __syncthreads();
    float s[2][4], dp[2][4];
    tile_product<D>(sQ, sK, ti, tj, s);
    tile_product<D>(sdO, sV, ti, tj, dp);
    form_p_ds(s, dp, sLse, sDi, ti, tj, i0, j0, m, scale, sP, sdS);
    __syncthreads();
#pragma unroll 4
    for (int li = 0; li < kT; ++li) {
      float qv[kE], ov[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        qv[e] = sQ[li * (D + 1) + dc + 16 * e];
        ov[e] = sdO[li * (D + 1) + dc + 16 * e];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = sP[li * (kT + 1) + jr + 8 * a];
        const float ds = sdS[li * (kT + 1) + jr + 8 * a];
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          acc_v[a][e] = fmaf(p, ov[e], acc_v[a][e]);
          acc_k[a][e] = fmaf(ds, qv[e], acc_k[a][e]);
        }
      }
    }
  }
  float* dkg = dk + b * st.dkb + h * st.dkh;
  float* dvg = dv + b * st.dvb + h * st.dvh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + jr + 8 * a;
    if (j >= Skv) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      dkg[(long long)j * st.dks + dc + 16 * e] = acc_k[a][e];
      dvg[(long long)j * st.dvs + dc + 16 * e] = acc_v[a][e];
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * kT * (D + 1) + 2 * kT * (kT + 1) + 2 * kT;
}

// One block per (b, h, kT query rows).  Pass 1 walks the key tiles the
// rows see and sums, per row, p = exp(S * scale - lse) and p * dP: the
// row's normaliser l and its Di.  It stores the row's own log-sum-exp
// lse + log(l) and Di = sum(p dP) / l to `stats` (for dkdv_kernel) and
// shared memory, so the rows of P that pass 2 forms sum to 1 and those of
// dS to 0 within float32 rounding.  Pass 2 accumulates dq = dS k.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const int32_t* __restrict__ kv_len,
          float* __restrict__ stats, float* __restrict__ dq, BwdStrides st, int H, int Sq,
          int Skv, int q_blocks, long long rows, float scale, int causal) {
  constexpr int kE = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kT * (D + 1);
  float* sK = sdO + kT * (D + 1);
  float* sV = sK + kT * (D + 1);
  float* sP = sV + kT * (D + 1);
  float* sdS = sP + kT * (kT + 1);
  float* sLse = sdS + kT * (kT + 1);
  float* sDi = sLse + kT;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / q_blocks;
  const int b = bh / H, h = bh % H;
  const int i0 = (blockIdx.x % q_blocks) * kT;
  const Masks m = make_masks(kv_len, b, Sq, Skv, causal);
  const float* kg = k + b * st.kb + h * st.kh;
  const float* vg = v + b * st.vb + h * st.vh;
  float* const lse_out = stats + (long long)bh * Sq;
  float* const di_out = stats + rows + (long long)bh * Sq;

  load_tile<D>(sQ, q + b * st.qb + h * st.qh, st.qs, i0, Sq);
  load_tile<D>(sdO, dout + b * st.db + h * st.dh, st.ds, i0, Sq);
  if (tid < kT) sLse[tid] = i0 + tid < Sq ? lse[(long long)bh * Sq + i0 + tid] : 0.0f;

  const int ti = tid >> 3, tj = tid & 7;
  // keys that some row of the tile sees (fully masked rows get no dq)
  const int kend = m.lim(min(i0 + kT, Sq) - 1);

  // pass 1: each row's normaliser and Di under the forward's lse
  float l_part[2] = {0.0f, 0.0f}, d_part[2] = {0.0f, 0.0f};
  for (int j0 = 0; j0 < kend; j0 += kT) {
    __syncthreads();  // the previous tile's sK and sV are consumed
    load_tile<D>(sK, kg, st.ks, j0, Skv);
    load_tile<D>(sV, vg, st.vs, j0, Skv);
    __syncthreads();
    float s[2][4], dp[2][4];
    tile_product<D>(sQ, sK, ti, tj, s);
    tile_product<D>(sdO, sV, ti, tj, dp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int li = 2 * ti + r;
      const int lim = m.lim(i0 + li);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tj + 8 * c;
        if (i0 + li < Sq && j < lim) {
          const float p = expf(fmaf(s[r][c], scale, -sLse[li]));
          l_part[r] += p;
          d_part[r] = fmaf(p, dp[r][c], d_part[r]);
        }
      }
    }
  }
  // the 8 threads of a row are 8 consecutive lanes
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], off);
      d_part[r] += __shfl_xor_sync(0xffffffffu, d_part[r], off);
    }
  }
  __syncthreads();  // every thread's pass-1 reads of sLse are done
  if (tj == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int li = 2 * ti + r, i = i0 + li;
      if (i >= Sq) continue;
      // a fully masked row (l = 0) keeps the forward's lse: only its dv
      // term 1/Skv is used, and its Di enters nothing
      const float lse_row = l_part[r] > 0.0f ? sLse[li] + logf(l_part[r]) : sLse[li];
      const float di = l_part[r] > 0.0f ? d_part[r] / l_part[r] : 0.0f;
      sLse[li] = lse_row;
      sDi[li] = di;
      lse_out[i] = lse_row;
      di_out[i] = di;
    }
  }

  // pass 2: dq += dS k
  const int ir = tid >> 4, dc = tid & 15;  // outputs: rows ir+8a, columns dc+16e
  float acc[4][kE];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[a][e] = 0.0f;
  for (int j0 = 0; j0 < kend; j0 += kT) {
    __syncthreads();  // sLse and sDi are written; the previous tile is consumed
    load_tile<D>(sK, kg, st.ks, j0, Skv);
    load_tile<D>(sV, vg, st.vs, j0, Skv);
    __syncthreads();
    float s[2][4], dp[2][4];
    tile_product<D>(sQ, sK, ti, tj, s);
    tile_product<D>(sdO, sV, ti, tj, dp);
    form_p_ds(s, dp, sLse, sDi, ti, tj, i0, j0, m, scale, sP, sdS);
    __syncthreads();
#pragma unroll 4
    for (int lj = 0; lj < kT; ++lj) {
      float kv[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) kv[e] = sK[lj * (D + 1) + dc + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = sdS[(ir + 8 * a) * (kT + 1) + lj];
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[a][e] = fmaf(ds, kv[e], acc[a][e]);
      }
    }
  }
  float* dqg = dq + b * st.dqb + h * st.dqh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ir + 8 * a;
    if (i >= Sq) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) dqg[(long long)i * st.dqs + dc + 16 * e] = acc[a][e];
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* kv_len, void* stats, void* dq, void* dk, void* dv,
               const BwdStrides& st, int B, int H, int Sq, int Skv, float scale, int causal,
               cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  const int k_blocks = (Skv + kT - 1) / kT, q_blocks = (Sq + kT - 1) / kT;
  const long long blocks_k = (long long)B * H * k_blocks, blocks_q = (long long)B * H * q_blocks;
  if (blocks_k > 0x7fffffffLL || blocks_q > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int smem_kv = dkdv_smem_floats<D>() * (int)sizeof(float);
  constexpr int smem_q = dq_smem_floats<D>() * (int)sizeof(float);
  static_assert(smem_kv <= 48 * 1024 && smem_q <= 48 * 1024, "static shared memory limit");
  // dq first: it writes each row's lse and Di, which dkdv reads
  dq_kernel<D><<<(unsigned)blocks_q, kThreads, smem_q, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const int32_t*)kv_len, (float*)stats, (float*)dq, st, H, Sq, Skv,
      q_blocks, rows, scale, causal);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<D><<<(unsigned)blocks_k, kThreads, smem_kv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)stats, (const float*)stats + rows, (const int32_t*)kv_len, (float*)dk,
      (float*)dv, st, H, Sq, Skv, k_blocks, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// strides: 21 int64, the (batch, head, row) strides in elements of q, k,
// v, do, dq, dk and dv.  lse is the forward's [B*H, Sq] float32
// (contiguous); stats is [2, B*H, Sq] float32 scratch the kernels fill
// (each row's own lse, then its Di).  kv_len may be null.  float32 only;
// returns cudaErrorInvalidValue for a head width other than 32 or 64, else
// cudaGetLastError() after the last launch.
int mt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* kv_len, void* stats, void* dq,
                           void* dk, void* dv, const long long* strides, int B, int H, int Sq,
                           int Skv, int D, float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  if (Skv <= 0) return (int)cudaErrorInvalidValue;
  BwdStrides st;
  long long* f = &st.qb;
  for (int i = 0; i < 21; ++i) f[i] = strides[i];
  if (D == 32) return launch_bwd<32>(q, k, v, dout, lse, kv_len, stats, dq, dk, dv, st, B, H, Sq, Skv, scale, causal, s);
  if (D == 64) return launch_bwd<64>(q, k, v, dout, lse, kv_len, stats, dq, dk, dv, st, B, H, Sq, Skv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
