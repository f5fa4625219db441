// The gradient of K2: dq, dk and dv of o = softmax(q k^T * scale + masks) v
// for float32 q [B,H,Sq,D] and k/v [B,H,Skv,D], D in {32, 64}, given the
// output's gradient do and each row's log-sum-exp lse [B*H, Sq] that the
// training forward (flash_attention.cu, mt_flash_attention_lse) writes.
// Operands are given by pointer and (batch, head, row) strides in
// elements, the last dimension contiguous and every row on a 16-byte
// boundary, as in the forward.
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
// lse) recomputed here does not sum to 1, nor does rowsum(do * o) equal
// sum_j P dP, to float32 precision (~1e-6).  A row of dS then fails to sum
// to 0 by that much, and where the keys are nearly equal (the reading-order
// ranker's boxes) dq = sum_j dS_ij k_j cancels down to the error: on an
// H100 the ranker's q/k weight gradients came out 4.2e-4 of their largest
// off the CPU's with Di = rowsum(do * o).  (The k weights see the same
// cancellation through sum_j dk_j = sum_i q_i sum_j dS_ij.)  So the dq
// kernel first sums, per row, p = exp(S * scale - lse) (the forward's lse
// keeps it in range) and p dP: the row's own lse is lse + log(sum p) and
// Di = sum(p dP) / sum(p).  Its second walk recomputes S and dP with the
// same code, so with the same bits, and the rows of dS it forms sum to 0
// within float32 rounding, as autograd's softmax gradient does.  The dk/dv
// kernel computes S^T = K Q^T and dP^T = V dO^T with the same products in
// the same order (mma_3xtf32_sweep's TRANS), so its dS has those bits too.
//
// What bounds it at the trainers' shapes (chip_smoke.py TRAIN_K2_CASES,
// counted by _bwd_work: q, do, dq, dk, dv and lse once, k and v up to the
// last key a row sees; 10 D flops a seen pair): bytes, at all six.  The
// byte bounds are 2.1-20 us on the H100 (3.35 TB/s).  The pairs that kv_len
// leaves take 1-18 us of float32 work at ~107 TFLOP/s, the rate 3xTF32 gets
// from mma.sync (TF32 at ~312-316 TFLOP/s measured, three MMAs a product),
// close to the bytes at the reading-order and base-classifier shapes.  This
// kernel does 14 D flops a seen pair (S and dP twice in the dq kernel) and
// is held in practice by latency: a dq block of the layout heads walks two
// key tiles, a dk/dv block its keys' query tiles one after another, at one
// to three warps an SM sub-partition, so its loads, exponentials and MMA
// chains do not overlap (PERF.md has the times and what was tried).  The
// design:
//   * All five products on the tensor cores in 3xTF32: each operand splits
//     into TF32 hi (truncated) and lo (the truncated remainder; hi + lo
//     holds x to 2^-20), each product is lo*hi + hi*lo + hi*hi on
//     mma.sync.m16n8k8.tf32 with a float32 accumulator (the forward's
//     split_tf32, mma_3xtf32 and load_a_tf32, copied here; the three MMAs of
//     a k-step go in sweeps over the warp's independent accumulators).  One
//     TF32 product a pair misses the 1e-4 contract by ~10x.
//   * P and dS stay in registers.  Each k-step's 8 columns are permuted to
//     (2t, 2t+1 | t = 0..3), as in the forward, so the accumulator of one
//     product is the A fragment of the next: dS of S = Q K^T feeds dS K
//     (dq); in the dk/dv kernel the keys are the M dimension, and P^T and
//     dS^T of S^T = K Q^T feed P^T dO and dS^T Q.  They are split into hi
//     and lo as they become A operands.
//   * dq = dS (K - k0) + (sum_j dS_ij) k0, k0 the head's key 0: where the
//     keys are nearly equal, 3xTF32's error on dS k_j (~2^-21 a product)
//     would not cancel as sum_j dS_ij = 0 does; on k_j - k0 it is that much
//     smaller (tests/test_torch_attention_grad.py holds a numpy model of this
//     kernel to twice the plain float32 gradient's error at such keys).
//   * 64-row blocks, each warp owning a 16-row m-tile: dq_kernel has 4 warps
//     per (b, h, 64 query rows); dkdv_kernel 2 groups of 4 warps per (b, h,
//     64 keys), each group taking every other query tile, their sums added
//     in shared memory at the end (in the trainers' batches only the key
//     blocks below kv_len work, so a block's walk is the critical path).
//     The block's own rows (Q and do, or K and V) are staged once and split
//     as each k-step reads them.  The other operand streams in tiles of 32
//     rows (64 at D=32) through a two-stage ring of 16-byte cp.async.cg
//     copies, one barrier a tile, the next tile loading while this one
//     computes.  Rows are padded to D+8 floats, so the 8-byte fragment
//     reads are conflict-free; the tiles that are also read as B of the
//     second product (K in dq_kernel, Q and do in dkdv_kernel: rows 2t and
//     2t+1 of one column) take a two-way bank conflict there.  A dq block
//     whose keys fit the ring (two tiles) loads them once for both walks.
//   * The skips: key tiles past kv_len and above the causal diagonal of a
//     block's last row; in dkdv_kernel the query tiles none of whose rows
//     sees a key of the block, unless the tile holds a fully masked row.
//   * Two launches (dq first: it writes each row's lse and Di, which dkdv
//     reads) and no atomics, so the same inputs give the same bits.
//
// Registers (nvcc 12.9 -Xptxas -v, sm_90a): dq_kernel 136 at D=64 and 160
// at D=32, dkdv_kernel 163 and 162; no instance spills.  Shared memory:
// dq 72 KB (D=64) and 60 KB (D=32), 3 blocks an SM; dk/dv 109 KB and
// 102 KB, one 256-thread block an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a dq block, keys of a dk/dv block
constexpr unsigned kFull = 0xffffffffu;

// rows of the streamed operand a tile holds (the forward's key tile)
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D == 32 ? 64 : 32;
}

struct BwdStrides {  // in elements; rows of D values are contiguous
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, db, dh, ds, dqb, dqh, dqs, dkb, dkh, dks,
      dvb, dvh, dvs;
};

struct Masks {
  int kvl, shift, causal;
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
  return m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t dst) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(0)
               : "memory");
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Stage `rows` rows of a row-strided [*, D] float32 operand (stride in
// elements) into shared rows of PITCH bytes, 16 bytes a cp.async, with
// kThreads threads (this one is `tid` of them); rows at or past `valid`
// are zero.  `rows` is a multiple of the kThreads / (D / 4) rows of one
// pass.
template <int D, int PITCH>
__device__ __forceinline__ void stage_rows(uint32_t dst, const float* src, long long stride,
                                           int rows, int valid, int tid) {
  constexpr int kChunks = D / 4, kPass = kThreads / kChunks;
  const int r = tid / kChunks;
  dst += r * PITCH + (tid % kChunks) * 16;
  src += r * stride + (tid % kChunks) * 4;
#pragma unroll 4
  for (int p = 0; p < rows / kPass; ++p) {
    if (r + p * kPass < valid) cp_async16(dst, src);
    else st_shared_zero16(dst);
    dst += kPass * PITCH;
    src += kPass * stride;
  }
}

// x -> hi + lo, both TF32 values (the low 13 bits zero): hi is x
// truncated, x - hi is exact in float32 and lo is it truncated, so hi + lo
// is x within 2^-20 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c[16x8] += a[16x8] b[8x8], tf32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[n] += a b[n] (b[n] = the n-th B fragment's two values) in 3xTF32 for N
// independent accumulators: a's lo times b's hi, a's hi times b's lo, then
// hi times hi (lo*lo, under 2^-20 of the product, is dropped), as the
// forward's mma_3xtf32.  TRANS swaps the first two: S^T = K Q^T then adds
// Q's lo times K's hi first, as S = Q K^T does, so each element of S^T is
// the same sum of the same products in the same order as in dq_kernel.
// The MMAs go in three sweeps over the N, so that none waits for the one
// before it to finish.
template <int N, bool TRANS = false>
__device__ __forceinline__ void mma_3xtf32_sweep(float (&c)[N][4], const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4],
                                                 const float (&b)[N][2]) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split_tf32(b[n][0], bh[n][0], bl[n][0]);
    split_tf32(b[n][1], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if constexpr (TRANS) mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
    else mma_tf32(c[n], al, bh[n][0], bh[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if constexpr (TRANS) mma_tf32(c[n], al, bh[n][0], bh[n][1]);
    else mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bh[n][0], bh[n][1]);
}

// The A fragment of k-step s from 16 staged float32 rows of PITCH floats,
// split into hi and lo.  The k-step's 8 columns are permuted so that lane
// (g, t) holds columns 2t, 2t+1 of rows g, g+8: one 8-byte load a row.
template <int PITCH>
__device__ __forceinline__ void load_a_tf32(const float* rows, int s, int g, int t,
                                            uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 r0 = *reinterpret_cast<const float2*>(rows + g * PITCH + 8 * s + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(rows + (g + 8) * PITCH + 8 * s + 2 * t);
  split_tf32(r0.x, hi[0], lo[0]);
  split_tf32(r1.x, hi[1], lo[1]);
  split_tf32(r0.y, hi[2], lo[2]);
  split_tf32(r1.y, hi[3], lo[3]);
}

// The accumulator of n-tile j (rows g, g+8; columns 2t, 2t+1) as the A
// fragment of k-step j, split into hi and lo
__device__ __forceinline__ void acc_to_a(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// x[16 x NT*8] = A B^T and y = C E^T for one warp: A and C its 16 staged
// rows, B and E the tile's NT*8 rows (all of PITCH floats).  TRANS: see
// mma_3xtf32_sweep.  dq_kernel calls this at one site for both of its
// walks.
template <int D, int NT, int PITCH, bool TRANS>
__device__ __forceinline__ void two_products(const float* A, const float* C, const float* Bm,
                                             const float* E, int g, int t,
                                             float (&x)[NT][4], float (&y)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ah[4], al[4], ch[4], cl[4];
    load_a_tf32<PITCH>(A, ks, g, t, ah, al);
    load_a_tf32<PITCH>(C, ks, g, t, ch, cl);
    float bv[NT][2], ev[NT][2];  // B fragment of n-tile j: row 8j+g, columns 2t, 2t+1
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(Bm + (8 * j + g) * PITCH + 8 * ks + 2 * t);
      const float2 e2 = *reinterpret_cast<const float2*>(E + (8 * j + g) * PITCH + 8 * ks + 2 * t);
      bv[j][0] = b2.x, bv[j][1] = b2.y, ev[j][0] = e2.x, ev[j][1] = e2.y;
    }
    mma_3xtf32_sweep<NT, TRANS>(x, ah, al, bv);
    mma_3xtf32_sweep<NT, TRANS>(y, ch, cl, ev);
  }
}

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 4 * (2 * kRows * (D + 8) + 2 * 2 * tile_rows<D>() * (D + 8));
}

// One block per (b, h, kRows query rows); warp w owns rows 16w..16w+15.
// Walk 1 goes over the key tiles the block's rows see and sums, per row,
// p = exp(S * scale - lse) and p dP: the row's normaliser l and its Di.  It
// stores the row's own log-sum-exp lse + log(l) and Di = sum(p dP) / l to
// `stats` (for dkdv_kernel).  Walk 2 recomputes S and dP, forms dS * scale
// and accumulates dq += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const int32_t* __restrict__ kv_len,
          float* __restrict__ stats, float* __restrict__ dq, BwdStrides st, int H, int Sq,
          int Skv, int q_blocks, long long rows, float scale, int causal) {
  constexpr int KT = tile_rows<D>();
  constexpr int kP = D + 8;        // floats a staged row
  constexpr int kSteps = D / 8;    // k-steps of S and dP, n-tiles of dq
  constexpr int kNT = KT / 8;      // n-tiles of S and dP, k-steps of dS K
  constexpr int kStage = 2 * KT * kP;
  extern __shared__ __align__(16) float smem_f32[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int bh = blockIdx.x / q_blocks;
  const int b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % q_blocks) * kRows;
  const int w0 = q0 + 16 * warp;  // this warp's first row
  float* const sQ = smem_f32;
  float* const sdO = sQ + kRows * kP;
  float* const sRing = sdO + kRows * kP;
  const float* const sQw = sQ + 16 * warp * kP;
  const float* const sdOw = sdO + 16 * warp * kP;

  const Masks m = make_masks(kv_len, b, Sq, Skv, causal);
  const float* kg = k + b * st.kb + h * st.kh;
  const float* vg = v + b * st.vb + h * st.vh;
  // keys that some row of the block sees (a fully masked row gets no dq)
  const int kend = m.lim(min(q0 + kRows, Sq) - 1);
  const int tiles = (kend + KT - 1) / KT;
  const bool resident = tiles <= 2;  // the ring holds every tile for both walks
  const int r0 = w0 + g, r1 = w0 + g + 8;  // this lane's rows
  const int lim0 = r0 < Sq ? m.lim(r0) : 0, lim1 = r1 < Sq ? m.lim(r1) : 0;
  const int unmasked = w0 + 15 < Sq ? m.lim(w0) : 0;  // keys all 16 rows see
  const bool active = w0 < Sq;
  const float* const lrow = lse + (long long)bh * Sq;
  float lse_r[2] = {r0 < Sq ? lrow[r0] : 0.0f, r1 < Sq ? lrow[r1] : 0.0f};
  float di_r[2] = {0.0f, 0.0f};
  float l_part[2] = {0.0f, 0.0f}, d_part[2] = {0.0f, 0.0f};  // this lane's part of walk 1
  float ds_part[2] = {0.0f, 0.0f};  // and of each row's sum of dS, walk 2
  // walk 2 takes dS (K - k0), then adds (sum_j dS_ij) k0 (the note at the
  // top); kref: k0's columns 8dn+g
  float kref[kSteps];
#pragma unroll
  for (int dn = 0; dn < kSteps; ++dn) kref[dn] = kg[8 * dn + g];

  // the rows' own lse and Di, to registers and `stats`; a fully masked row
  // (l = 0) keeps the forward's lse: only its dv term 1/Skv is used, and
  // its Di enters nothing
  auto finish_stats = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_part[r]), d = quad_sum(d_part[r]);
      if (l > 0.0f) {
        lse_r[r] += logf(l);
        di_r[r] = d / l;
      }
    }
    float* const lse_out = stats + (long long)bh * Sq;
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? r1 : r0;
        if (i < Sq) {
          lse_out[i] = lse_r[r];
          lse_out[rows + i] = di_r[r];
        }
      }
    }
  };

  auto stage_tile = [&](int tile, int slot) {
    float* sK = sRing + slot * kStage;
    const int t0 = tile * KT;
    stage_rows<D, 4 * kP>(smem_u32(sK), kg + t0 * st.ks, st.ks, KT, kend - t0, threadIdx.x);
    stage_rows<D, 4 * kP>(smem_u32(sK + KT * kP), vg + t0 * st.vs, st.vs, KT, kend - t0,
                          threadIdx.x);
  };

  float acc[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  if (tiles > 0) {
    // one cp.async group a tile; Q and do in the first
    stage_rows<D, 4 * kP>(smem_u32(sQ), q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, kRows,
                          Sq - q0, threadIdx.x);
    stage_rows<D, 4 * kP>(smem_u32(sdO), dout + b * st.db + h * st.dh + q0 * st.ds, st.ds,
                          kRows, Sq - q0, threadIdx.x);
    stage_tile(0, 0);
    cp_async_commit();
    if (resident && tiles == 2) {
      stage_tile(1, 1);
      cp_async_commit();
    }
  }
  for (int it = 0; it < 2 * tiles; ++it) {
    const int tile = it < tiles ? it : it - tiles;
    int slot;
    if (resident) {
      if (it < tiles) {  // tile `it` has landed (tile 1 may still be in flight at it = 0)
        if (it + 1 < tiles) cp_async_wait<1>();
        else cp_async_wait<0>();
        __syncthreads();
      }
      slot = tile;
    } else {
      cp_async_wait<0>();  // this thread's part of the tile has landed
      __syncthreads();     // every thread's part has, and the last tile is consumed
      if (it + 1 < 2 * tiles) stage_tile((it + 1) % tiles, (it + 1) & 1);
      cp_async_commit();
      slot = it & 1;
    }
    if (!active) continue;
    const float* sK = sRing + slot * kStage;
    const float* sV = sK + KT * kP;
    const int t0 = tile * KT;
    const bool edge = t0 + KT > unmasked;  // the tile holds a pair some row does not see

    // S = Q K^T and dP = dO V^T: one call site, so both walks get the same bits
    float s[kNT][4], dp[kNT][4];
    two_products<D, kNT, kP, false>(sQw, sdOw, sK, sV, g, t, s, dp);

    if (it < tiles) {  // walk 1: each row's normaliser and Di under the forward's lse
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kj = t0 + 8 * j + 2 * t + (e & 1);
          if (!edge || kj < (r ? lim1 : lim0)) {
            const float p = expf(fmaf(s[j][e], scale, -lse_r[r]));
            l_part[r] += p;
            d_part[r] = fmaf(p, dp[j][e], d_part[r]);
          }
        }
      }
      continue;
    }
    if (it == tiles) finish_stats();
    // walk 2: dS * scale, then dq += dS (K - k0).  B fragment of k-step j:
    // keys 8j+2t, 8j+2t+1 of K, column g of each n-tile.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kj = t0 + 8 * j + 2 * t + (e & 1);
        ds[e] = 0.0f;
        if (!edge || kj < (r ? lim1 : lim0)) {
          const float p = expf(fmaf(s[j][e], scale, -lse_r[r]));
          ds[e] = p * (dp[j][e] - di_r[r]) * scale;
        }
        ds_part[r] += ds[e];
      }
      uint32_t ah[4], al[4];
      acc_to_a(ds, ah, al);
      const float* kr = sK + (8 * j + 2 * t) * kP + g;
      float kb[kSteps][2];
#pragma unroll
      for (int dn = 0; dn < kSteps; ++dn) {
        kb[dn][0] = kr[8 * dn] - kref[dn];
        kb[dn][1] = kr[kP + 8 * dn] - kref[dn];
      }
      mma_3xtf32_sweep(acc, ah, al, kb);
    }
  }
  if (!active) return;
  if (tiles == 0) finish_stats();
  // dq = dS (K - k0) + (sum_j dS) k0
  const float ds0 = quad_sum(ds_part[0]), ds1 = quad_sum(ds_part[1]);
  float* dqg = dq + b * st.dqb + h * st.dqh;
#pragma unroll
  for (int dn = 0; dn < kSteps; ++dn) {
    const int c = 8 * dn + 2 * t;
    const float2 k0c = *reinterpret_cast<const float2*>(kg + c);
    acc[dn][0] = fmaf(ds0, k0c.x, acc[dn][0]);
    acc[dn][1] = fmaf(ds0, k0c.y, acc[dn][1]);
    acc[dn][2] = fmaf(ds1, k0c.x, acc[dn][2]);
    acc[dn][3] = fmaf(ds1, k0c.y, acc[dn][3]);
    if (r0 < Sq) *reinterpret_cast<float2*>(dqg + (long long)r0 * st.dqs + c) = make_float2(acc[dn][0], acc[dn][1]);
    if (r1 < Sq) *reinterpret_cast<float2*>(dqg + (long long)r1 * st.dqs + c) = make_float2(acc[dn][2], acc[dn][3]);
  }
}

// A dk/dv block's warp groups: each takes every other query tile of the
// block, and their sums are added in shared memory at the end
constexpr int kGroups = 2;

// this warp group's barrier (named barrier 1 + group; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kThreads) : "memory");
}

template <int D>
__host__ __device__ constexpr int dkdv_ring_floats() {  // one group's two stages: Q, dO, the rows' lse and Di
  return 2 * (2 * tile_rows<D>() * (D + 8) + 2 * tile_rows<D>());
}

template <int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  return 4 * (2 * kRows * (D + 8) + kGroups * dkdv_ring_floats<D>());
}

// One block per (b, h, kRows keys), kGroups groups of 4 warps; warp w of a
// group owns keys 16w..16w+15.  The block walks the query tiles that hold a
// row seeing a key of the block, or a fully masked row; group g takes the
// g-th, (g + kGroups)-th, ... of them, streaming its own ring.  A tile:
// S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T * scale from the rows'
// own lse and Di (`stats`, written by dq_kernel), and dv += P^T dO, dk +=
// dS^T Q.  At the end group 1's sums go through shared memory into group
// 0's, which stores them: a fixed order, so the bits do not vary.
template <int D>
__global__ void __launch_bounds__(kThreads * kGroups)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            const int32_t* __restrict__ kv_len, float* __restrict__ dk,
            float* __restrict__ dv, BwdStrides st, int H, int Sq, int Skv, int k_blocks,
            float scale, int causal) {
  static_assert(kGroups == 2, "the reduction below adds one group into another");
  constexpr int KT = tile_rows<D>();
  constexpr int kP = D + 8;
  constexpr int kSteps = D / 8;  // k-steps of S^T and dP^T, n-tiles of dk and dv
  constexpr int kNT = KT / 8;    // n-tiles of S^T and dP^T, k-steps of dk and dv
  constexpr int kStage = dkdv_ring_floats<D>() / 2;  // Q, dO, then the rows' lse and Di
  constexpr int kPart = kWarps * kSteps * 4 * 32;    // a group's dk (or dv) fragments
  static_assert(2 * kPart <= dkdv_ring_floats<D>(), "group 1's sums fit its ring");
  extern __shared__ __align__(16) float smem_f32[];

  const int grp = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / k_blocks;
  const int b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x % k_blocks) * kRows;
  const int j0 = k0 + 16 * warp;  // this warp's first key
  float* const sK = smem_f32;
  float* const sV = sK + kRows * kP;
  float* const sRing = sV + kRows * kP + grp * dkdv_ring_floats<D>();
  const float* const sKw = sK + 16 * warp * kP;
  const float* const sVw = sV + 16 * warp * kP;

  const Masks m = make_masks(kv_len, b, Sq, Skv, causal);
  const float* qg = q + b * st.qb + h * st.qh;
  const float* dg = dout + b * st.db + h * st.dh;
  const float* lg = lse + (long long)bh * Sq;
  const float* dig = di + (long long)bh * Sq;
  const int nq = (Sq + KT - 1) / KT;
  // a row of the tile sees key k0, or a row is fully masked
  auto wanted = [&](int i) {
    const int i0 = i * KT;
    return m.lim(min(i0 + KT, Sq) - 1) > k0 || m.lim(i0) == 0;
  };
  auto next_tile = [&](int i) {
    while (i < nq && !wanted(i)) ++i;
    return i;
  };
  auto stage_tile = [&](int tile, int slot) {
    float* sQt = sRing + slot * kStage;
    const int i0 = tile * KT;
    stage_rows<D, 4 * kP>(smem_u32(sQt), qg + i0 * st.qs, st.qs, KT, Sq - i0, tid);
    stage_rows<D, 4 * kP>(smem_u32(sQt + KT * kP), dg + i0 * st.ds, st.ds, KT, Sq - i0, tid);
    float* sL = sQt + 2 * KT * kP;
    const int x = tid % KT;
    if (tid < 2 * KT) {
      float* dst = tid < KT ? sL + x : sL + KT + x;
      if (i0 + x < Sq) cp_async4(smem_u32(dst), (tid < KT ? lg : dig) + i0 + x);
      else *dst = 0.0f;
    }
  };

  const float uniform = 1.0f / (float)Skv;
  const bool active = j0 < Skv;
  float acc_k[kSteps][4], acc_v[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.0f;

  int cur = next_tile(0);
  const bool any = cur < nq;  // the block has a tile to walk
  if (grp == 1) cur = next_tile(cur + 1);
  if (any) {  // group 0 stages K, group 1 V, each its first tile; all wait
    if (grp == 0) {
      stage_rows<D, 4 * kP>(smem_u32(sK), k + b * st.kb + h * st.kh + k0 * st.ks, st.ks,
                            kRows, Skv - k0, tid);
    } else {
      stage_rows<D, 4 * kP>(smem_u32(sV), v + b * st.vb + h * st.vh + k0 * st.vs, st.vs,
                            kRows, Skv - k0, tid);
    }
    if (cur < nq) stage_tile(cur, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const int key0 = j0 + g, key1 = j0 + g + 8;  // this lane's keys
  for (int it = 0; cur < nq; ++it) {
    if (it > 0) {
      cp_async_wait<0>();  // this thread's part of the tile has landed
      group_sync(grp);     // the group's has, and its last tile is consumed
    }
    const int nxt = next_tile(next_tile(cur + 1) + 1);
    if (nxt < nq) stage_tile(nxt, (it + 1) & 1);
    cp_async_commit();
    if (active) {
      const float* sQt = sRing + (it & 1) * kStage;
      const float* sdOt = sQt + KT * kP;
      const float* sL = sdOt + KT * kP;
      const float* sDi = sL + KT;
      const int i0 = cur * KT;

      // S^T = K Q^T and dP^T = V dO^T, element (key, query) as in dq_kernel
      float s[kNT][4], dp[kNT][4];
      two_products<D, kNT, kP, true>(sKw, sVw, sQt, sdOt, g, t, s, dp);

      // P^T and dS^T * scale; element e of n-tile j: key g + 8(e >> 1), query
      // 8j + 2t + (e & 1).  Then dv += P^T dO and dk += dS^T Q, with B
      // fragments from rows 8j+2t, 8j+2t+1 of dO and Q, column g of each
      // n-tile.
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 lq = *reinterpret_cast<const float2*>(sL + 8 * j + 2 * t);
        const float2 dq2 = *reinterpret_cast<const float2*>(sDi + 8 * j + 2 * t);
        float p[4], ds[4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = i0 + 8 * j + 2 * t + c;
          const int lim = qi < Sq ? m.lim(qi) : -1;  // -1: a padding row, no pair
          const float lq_c = c ? lq.y : lq.x, di_c = c ? dq2.y : dq2.x;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c, key = r ? key1 : key0;
            p[e] = 0.0f;
            ds[e] = 0.0f;
            if (lim == 0) {
              p[e] = uniform;
            } else if (key < lim) {
              p[e] = expf(fmaf(s[j][e], scale, -lq_c));
              ds[e] = p[e] * (dp[j][e] - di_c) * scale;
            }
          }
        }
        uint32_t ph[4], pl[4], dh[4], dl[4];
        acc_to_a(p, ph, pl);
        acc_to_a(ds, dh, dl);
        const float* orow = sdOt + (8 * j + 2 * t) * kP + g;
        const float* qrow = sQt + (8 * j + 2 * t) * kP + g;
        float ob[kSteps][2], qb[kSteps][2];
#pragma unroll
        for (int dn = 0; dn < kSteps; ++dn) {
          ob[dn][0] = orow[8 * dn], ob[dn][1] = orow[kP + 8 * dn];
          qb[dn][0] = qrow[8 * dn], qb[dn][1] = qrow[kP + 8 * dn];
        }
        mma_3xtf32_sweep(acc_v, ph, pl, ob);
        mma_3xtf32_sweep(acc_k, dh, dl, qb);
      }
    }
    cur = nxt;
  }
  if (any) {  // group 1's sums, lane by lane, into group 0's
    float* const part = sV + kRows * kP + dkdv_ring_floats<D>();  // group 1's ring
    float* const mine = part + (warp * kSteps * 4) * 32 + lane;
    if (grp == 1) {
      group_sync(1);  // group 1's last reads of its ring are done
#pragma unroll
      for (int dn = 0; dn < kSteps; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mine[(dn * 4 + e) * 32] = acc_k[dn][e];
          mine[kPart + (dn * 4 + e) * 32] = acc_v[dn][e];
        }
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int dn = 0; dn < kSteps; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc_k[dn][e] += mine[(dn * 4 + e) * 32];
          acc_v[dn][e] += mine[kPart + (dn * 4 + e) * 32];
        }
    }
  }
  if (grp != 0 || !active) return;
  float* dkg = dk + b * st.dkb + h * st.dkh;
  float* dvg = dv + b * st.dvb + h * st.dvh;
#pragma unroll
  for (int dn = 0; dn < kSteps; ++dn) {
    const int c = 8 * dn + 2 * t;
    if (key0 < Skv) {
      *reinterpret_cast<float2*>(dkg + (long long)key0 * st.dks + c) = make_float2(acc_k[dn][0], acc_k[dn][1]);
      *reinterpret_cast<float2*>(dvg + (long long)key0 * st.dvs + c) = make_float2(acc_v[dn][0], acc_v[dn][1]);
    }
    if (key1 < Skv) {
      *reinterpret_cast<float2*>(dkg + (long long)key1 * st.dks + c) = make_float2(acc_k[dn][2], acc_k[dn][3]);
      *reinterpret_cast<float2*>(dvg + (long long)key1 * st.dvs + c) = make_float2(acc_v[dn][2], acc_v[dn][3]);
    }
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* kv_len, void* stats, void* dq, void* dk, void* dv,
               const BwdStrides& st, int B, int H, int Sq, int Skv, float scale, int causal,
               cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  const int k_blocks = (Skv + kRows - 1) / kRows, q_blocks = (Sq + kRows - 1) / kRows;
  const long long blocks_k = (long long)B * H * k_blocks, blocks_q = (long long)B * H * q_blocks;
  if (blocks_k > 0x7fffffffLL || blocks_q > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int smem_q = dq_smem_bytes<D>(), smem_kv = dkdv_smem_bytes<D>();
  // above 48 KB of shared memory, once a device (the call costs host time,
  // and the trainers' steps are bound by the host)
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ready.load() & bit)) {
    e = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(bit);
  }
  // dq first: it writes each row's lse and Di, which dkdv reads
  dq_kernel<D><<<(unsigned)blocks_q, kThreads, smem_q, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const int32_t*)kv_len, (float*)stats, (float*)dq, st, H, Sq, Skv,
      q_blocks, rows, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<D><<<(unsigned)blocks_k, kThreads * kGroups, smem_kv, stream>>>(
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
