// Fused attention: softmax(Q K^T * scale + masks) V with float32
// scores, softmax and sums, for q [B,H,Sq,D] and k/v [B,H,Skv,D]
// (float32 or bf16) given by pointer and (batch, head, row) strides in
// elements (the last dimension is contiguous), an optional bottom-right
// causal mask and an optional per-batch kv_len right-padding mask.
// Masked logits are -1e30, so a fully masked row averages V; keys past
// Skv weigh nothing.
//
// Replaces the TPU kernel marie_tpu/ops/pallas/flash_attention.py
// (flash_attention, kernel _flash_kernel).  On the TPU the grid walks
// (B*H, Sq/128) in order with D padded to 128, and the JAX wrapper falls
// back to plain einsum for D=64, which every shipped model uses.  This
// file covers D in {32, 64, 128} and any Sq, Skv.
//
// bf16 (the encoder: B=256 crops, H=6, S=20, D=64): bound by bytes, about
// 157 MFLOP against 15.7 MB, so the design keeps loads wide and the
// arithmetic off the critical path.
//   * Tensor cores via mma.sync.m16n8k16 (bf16 in, float32 accumulate),
//     fed by ldmatrix.  Q K^T of bf16 values is exact per product in
//     float32, as _flash_kernel's preferred_element_type=float32; only the
//     order of the sum differs.  P V keeps the TPU kernel's float32 P:
//     P is split into hi = bf16(p) and lo = bf16(p - hi), two MMAs into
//     one float32 accumulator, so P keeps ~16 bits.
//   * wgmma is not used: it needs 64-row tiles and one head has 20 query
//     rows; packing heads into 64 rows makes the score product
//     block-diagonal, and the arithmetic is not what bounds this shape.
//   * One warp per (b, h) and one block per b (heads split over blocks
//     when H > 8 or shared memory runs short).  The warp stages its
//     head's Q (up to 64 rows at a time), K and V (a tile of KT = 32 or
//     64 keys) with 16-byte cp.async.cg into rows padded by 16 bytes, so
//     ldmatrix's 8 row addresses fall in 8 distinct bank groups.  At the
//     encoder's [B,S,H,D] projection layout a block's rows are three
//     contiguous 15 KB runs.  Queries go in 16-row m-tiles (padded rows
//     are zero and never stored), keys in 8-wide n-tiles; rows past Skv
//     are zero and their scores -inf.  The softmax runs on the
//     accumulator fragments, with quad shuffles for the row max and a
//     quad sum at the end.  Skv <= 64 is one pass with no rescale; longer
//     Skv loops over 64-key tiles with the online rescale.  The output is
//     staged through the spent Q rows and written with 16-byte stores.
//   * What bounds it at the encoder's shape (measured on an H100): all
//     256 blocks are resident at once, so every warp waits for its data
//     and then all compute together, bound by instruction issue (12
//     warps an SM).  The key-tile width and the
//     masks are template parameters so that the common case runs no
//     per-element mask and no dead n-tile branch.  Two heads per warp,
//     the second prefetched while the first computes, measured slower.
//   * No block-level barrier: a warp only touches its own shared memory.
// float32: a SIMT kernel (TF32 would break the 1e-4 float32 limit; not
// on the main path): one block of 4 warps per (b*h, 16 query rows), K/V
// tiles of 32 keys in shared memory as float32, lane j scores key j,
// online softmax with warp shuffles.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, printed by
// chip_smoke.py's device phase): see PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // in elements; rows of D values are contiguous
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ---------------------------------------------------------------- bf16 path

constexpr int kMaxHeadsPerBlock = 8;
constexpr int kTile = 64;  // most query rows / keys staged at once
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t dst) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> bf16 pairs hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Stage `rows` (a multiple of 16) rows of a row-strided [*, D] operand
// into shared memory rows of 2D+16 bytes; rows at or past `valid` are
// zero.  One warp-wide pass copies 32 / (D/8) rows, 16 bytes a lane.
template <int D>
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* src,
                                           long long stride, int rows, int valid,
                                           int lane) {
  constexpr int kChunks = D / 8, kPass = 32 / kChunks, kPitch = 2 * D + 16;
  const int r = lane / kChunks;
  dst += r * kPitch + (lane % kChunks) * 16;
  src += r * stride + (lane % kChunks) * 8;
#pragma unroll 4
  for (int i = r; i < rows; i += kPass) {
    if (i < valid) cp_async16(dst, src);
    else st_shared_zero16(dst);
    dst += kPass * kPitch;
    src += kPass * stride;
  }
}

__host__ __device__ inline int warp_smem_bytes(int D, int KT, int Sq) {
  return (round16(Sq < kTile ? Sq : kTile) + 2 * KT) * (2 * D + 16);
}

// KT: keys staged per tile (32 or 64); MASK: causal and/or kv_len masks
// are on (without them only keys past Skv are cut).
template <int D, int KT, bool MASK>
__global__ void __launch_bounds__(kMaxHeadsPerBlock * 32)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int32_t* __restrict__ kv_len,
                 bf16* __restrict__ o, Strides st, int H, int heads_per_block,
                 int Sq, int Skv, float scale_log2, int causal) {
  constexpr int kPitch = 2 * D + 16;  // bytes per staged row
  constexpr int kSteps = D / 16;      // k-steps of Q K^T
  constexpr int kOut = D / 8;         // n-tiles of the output
  constexpr int kNT = KT / 8;         // key n-tiles per tile
  constexpr int kChunks = D / 8, kPass = 32 / kChunks;
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int h = blockIdx.y * heads_per_block + warp;
  if (h >= H) return;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  unsigned char* const sQ_ptr = smem + warp * warp_smem_bytes(D, KT, Sq);
  const uint32_t sQ = smem_u32(sQ_ptr);
  const uint32_t sK = sQ + round16(min(Sq, kTile)) * kPitch;
  const uint32_t sV = sK + KT * kPitch;

  const bf16* qg = q + b * st.qb + h * st.qh;
  const bf16* kg = k + b * st.kb + h * st.kh;
  const bf16* vg = v + b * st.vb + h * st.vh;
  bf16* og = o + b * st.ob + h * st.oh;
  const int kvl = MASK && kv_len ? kv_len[b] : Skv;
  const int shift = Skv - Sq;  // bottom-right causal alignment
  const bool one_tile = Skv <= KT;

  if (one_tile) {
    stage_rows<D>(sK, kg, st.ks, KT, Skv, lane);
    stage_rows<D>(sV, vg, st.vs, KT, Skv, lane);
  }
  for (int q0 = 0; q0 < Sq; q0 += kTile) {
    const int m_tiles = round16(min(Sq - q0, kTile)) / 16;
    stage_rows<D>(sQ, qg + q0 * st.qs, st.qs, 16 * m_tiles, Sq - q0, lane);
    cp_async_wait_all();
    __syncwarp();

    for (int mt = 0; mt < m_tiles; ++mt) {
      const int m0 = q0 + 16 * mt;
      unsigned char* const rows = sQ_ptr + 16 * mt * kPitch;
      uint32_t qa[kSteps][4];
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        ldmatrix_x4(qa[s], smem_u32(rows) + (lane & 15) * kPitch + (16 * s + (lane >> 4) * 8) * 2);

      float acc[kOut][4];
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      float row_max[2] = {-INFINITY, -INFINITY};
      float row_sum[2] = {0.0f, 0.0f};  // this lane's part; quad sum at the end

      for (int t0 = 0; t0 < Skv; t0 += KT) {
        if (!one_tile) {
          __syncwarp();  // the previous tile is consumed
          stage_rows<D>(sK, kg + t0 * st.ks, st.ks, KT, Skv - t0, lane);
          stage_rows<D>(sV, vg + t0 * st.vs, st.vs, KT, Skv - t0, lane);
          cp_async_wait_all();
          __syncwarp();
        }
        const int live = Skv - t0;  // keys of this tile below Skv (may exceed KT)

        // S = Q K^T (keys past Skv are zero rows)
        float s[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
          for (int kk = 0; kk < D / 32; ++kk) {
            uint32_t kb[4];
            ldmatrix_x4(kb, sK + (8 * j + (lane & 7)) * kPitch + (32 * kk + (lane >> 3) * 8) * 2);
            mma_bf16(s[j], qa[2 * kk], kb[0], kb[1]);
            mma_bf16(s[j], qa[2 * kk + 1], kb[2], kb[3]);
          }
        }

        // masks and scale (log2 domain), row max over the quad
        float tile_max[2] = {row_max[0], row_max[1]};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 8 * j + 2 * t + (e & 1);  // key within the tile
            float x = s[j][e] * scale_log2;
            if (MASK) {
              const int qi = m0 + g + 8 * (e >> 1), kj = t0 + kk;
              if (kj >= kvl || (causal && qi < kj - shift)) x = kMasked;
            }
            s[j][e] = kk < live ? x : -INFINITY;
            tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[j][e]);
          }
        }
        tile_max[0] = quad_max(tile_max[0]);
        tile_max[1] = quad_max(tile_max[1]);
        if (t0 > 0) {  // online rescale of what earlier tiles summed
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float alpha = fast_exp2(row_max[r] - tile_max[r]);
            row_sum[r] *= alpha;
#pragma unroll
            for (int j = 0; j < kOut; ++j) {
              acc[j][2 * r] *= alpha;
              acc[j][2 * r + 1] *= alpha;
            }
          }
        }
        row_max[0] = tile_max[0];
        row_max[1] = tile_max[1];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = fast_exp2(s[j][e] - row_max[e >> 1]);
            row_sum[e >> 1] += s[j][e];
          }
        }

        // O += P V over 16-key chunks; P as hi + lo bf16 (two MMAs)
#pragma unroll
        for (int c = 0; c < KT / 16; ++c) {
          uint32_t ph[4], pl[4];
          split_bf16(s[2 * c][0], s[2 * c][1], ph[0], pl[0]);
          split_bf16(s[2 * c][2], s[2 * c][3], ph[1], pl[1]);
          split_bf16(s[2 * c + 1][0], s[2 * c + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * c + 1][2], s[2 * c + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, sV + (16 * c + (lane & 15)) * kPitch + (16 * dp + (lane >> 4) * 8) * 2);
            mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
            mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
            mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
            mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
          }
        }
      }

      // normalise, stage through this m-tile's spent Q rows, store 16 B a lane
      const float inv0 = __fdividef(1.0f, quad_sum(row_sum[0]));
      const float inv1 = __fdividef(1.0f, quad_sum(row_sum[1]));
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int col = (8 * j + 2 * t) * 2;
        *reinterpret_cast<uint32_t*>(rows + g * kPitch + col) =
            pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
        *reinterpret_cast<uint32_t*>(rows + (g + 8) * kPitch + col) =
            pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
      }
      __syncwarp();
      const int r = lane / kChunks;
      const unsigned char* src = rows + r * kPitch + (lane % kChunks) * 16;
      bf16* dst = og + (long long)(m0 + r) * st.os + (lane % kChunks) * 8;
#pragma unroll
      for (int i = r; i < 16; i += kPass) {
        if (m0 + i < Sq) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        src += kPass * kPitch;
        dst += kPass * st.os;
      }
    }
    __syncwarp();  // staged outputs read before the next Q chunk lands
  }
}

template <int D, int KT, bool MASK>
int launch_tiles(const void* q, const void* k, const void* v, const void* kv_len,
               void* o, const Strides& st, int B, int H, int Sq, int Skv,
               float scale, int causal, cudaStream_t stream) {
  const int per_warp = warp_smem_bytes(D, KT, Sq);
  int heads = std::min(H, std::min(kMaxHeadsPerBlock, kSmemLimit / per_warp));
  const int blocks_per_b = (H + heads - 1) / heads;
  heads = (H + blocks_per_b - 1) / blocks_per_b;  // balance the blocks of one b
  const int smem = heads * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D, KT, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_mma_kernel<D, KT, MASK><<<dim3(B, blocks_per_b), heads * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int32_t*)kv_len,
      (bf16*)o, st, H, heads, Sq, Skv, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* kv_len,
               void* o, const Strides& st, int B, int H, int Sq, int Skv,
               float scale, int causal, cudaStream_t stream) {
  const bool mask = causal || kv_len;
  if (Skv <= 32)
    return mask ? launch_tiles<D, 32, true>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, stream)
                : launch_tiles<D, 32, false>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, stream);
  return mask ? launch_tiles<D, 64, true>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, stream)
              : launch_tiles<D, 64, false>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, stream);
}

// ------------------------------------------------------------- float32 path

constexpr int kBQ = 16;   // query rows per block
constexpr int kBKV = 32;  // keys per shared-memory tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int32_t* __restrict__ kv_len,
                  float* __restrict__ o, Strides st, int H, int Sq, int Skv,
                  float scale, int causal) {
  constexpr int DPL = D / 32;  // output columns per lane
  __shared__ float Qs[kBQ][D];
  __shared__ float Ks[kBKV][D + 1];
  __shared__ float Vs[kBKV][D];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* qg = q + b * st.qb + h * st.qh;
  const float* kg = k + b * st.kb + h * st.kh;
  const float* vg = v + b * st.vb + h * st.vh;
  float* og = o + b * st.ob + h * st.oh;
  const int kvl = kv_len ? kv_len[b] : Skv;
  const int shift = Skv - Sq;

  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    Qs[r][d] = (q0 + r < Sq) ? qg[(long long)(q0 + r) * st.qs + d] : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kMasked;
    l[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[rr][c] = 0.0f;
  }

  for (int t0 = 0; t0 < Skv; t0 += kBKV) {
    __syncthreads();  // Qs written / previous tile consumed
    for (int i = threadIdx.x; i < kBKV * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const int kj = t0 + j;
      Ks[j][d] = kj < Skv ? kg[(long long)kj * st.ks + d] : 0.0f;
      Vs[j][d] = kj < Skv ? vg[(long long)kj * st.vs + d] : 0.0f;
    }
    __syncthreads();
    const int kj = t0 + lane;
    const int nkeys = min(kBKV, Skv - t0);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      float s;
      if (kj >= Skv) {
        s = -INFINITY;
      } else {
        float dot = 0.0f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(Qs[r][d], Ks[lane][d], dot);
        s = dot * scale;
        if (kj >= kvl || (causal && qi < kj - shift)) s = kMasked;
      }
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[rr][c] *= alpha;
      for (int j = 0; j < nkeys; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[rr][c] = fmaf(pj, Vs[j][lane + 32 * c], acc[rr][c]);
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= Sq) continue;
    const float inv = 1.0f / l[rr];
#pragma unroll
    for (int c = 0; c < DPL; ++c) og[(long long)qi * st.os + lane + 32 * c] = acc[rr][c] * inv;
  }
}

template <int D>
int launch_simt(const void* q, const void* k, const void* v, const void* kv_len,
                void* o, const Strides& st, int B, int H, int Sq, int Skv,
                float scale, int causal, cudaStream_t stream) {
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_simt_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int32_t*)kv_len,
      (float*)o, st, H, Sq, Skv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 int64, the (batch, head,
// row) strides in elements of q, k, v and o.  kv_len may be null (all
// keys valid).  bf16 rows must start on 16-byte boundaries.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// head width or dtype the kernel does not take.
int mt_flash_attention(const void* q, const void* k, const void* v,
                       const void* kv_len, void* o, const long long* strides,
                       int B, int H, int Sq, int Skv, int D, int dtype,
                       float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  if (Skv <= 0) return (int)cudaErrorInvalidValue;
  Strides st;
  long long* f = &st.qb;
  for (int i = 0; i < 12; ++i) f[i] = strides[i];
  if (dtype == 0 && D == 32) return launch_simt<32>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  if (dtype == 0 && D == 64) return launch_simt<64>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  if (dtype == 0 && D == 128) return launch_simt<128>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  if (dtype == 1 && D == 32) return launch_mma<32>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  if (dtype == 1 && D == 64) return launch_mma<64>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  if (dtype == 1 && D == 128) return launch_mma<128>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
