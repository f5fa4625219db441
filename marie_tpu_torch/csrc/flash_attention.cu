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
// float32 (the LayoutLM heads, D=64, kv_len masking each page's padding:
// the chained heads at B=16 pages, 4 heads, 192 tokens; at base width the
// classifier at B=16, 12 heads, 708 tokens and the indexer at 7 windows
// of 512): bound by operations at the base shapes (14.7 GFLOP of products
// in the pairs kv_len leaves, against 26 MB) and by bytes at the chain
// shape.  The contract is float32 accuracy (1e-4 against the plain
// version), which one TF32 product per pair misses by ~10x.
//   * Tensor cores in 3xTF32: each operand splits into hi + lo, both TF32
//     (hi truncated, lo the truncated remainder: hi + lo holds x to
//     2^-20), and each product is lo*hi + hi*lo + hi*hi, accumulated in
//     float32 by mma.sync.m16n8k8.tf32.  Integer masks split: the kernel
//     is bound by instruction issue as much as by the tensor cores, and
//     cvt.rna.tf32.f32 adds a NaN check to the rounding.  torch's TF32
//     switches play no part.
//   * Key tiles that no row of a block can see are skipped: past kv_len
//     and, when causal, past the diagonal of the block's last row.  A
//     block with a fully masked row (kv_len 0, or causal rows above the
//     diagonal when Sq > Skv) walks every key, since such a row averages
//     V over all of Skv in the plain version.  (_flash_kernel skips
//     causal blocks and gives such rows 0.)
//   * One block of 4 warps per (b, h, 64 query rows); each warp owns a
//     16-row m-tile and keeps its split Q in registers (D <= 64).  Tiles
//     of 32 keys (64 at D=32, 16 at D=128) are staged by all threads
//     with 16-byte cp.async.cg into a two-stage ring: one barrier a tile,
//     the next tile loading while this one computes.  Each k-step's 8
//     columns are permuted to (2t, 2t+1 | t = 0..3), so a lane reads its
//     B fragment of K with one 8-byte load (rows padded to D+8 floats:
//     no bank conflict), and the score accumulator of n-tile j is the A
//     fragment of PV's k-step j: P stays in registers, with no shuffle.
//     V rows are padded to D+4 so the scalar reads of rows 2t, 2t+1 miss
//     each other's banks.  The online softmax runs on the accumulator
//     fragments with quad shuffles; the output is staged through the
//     warp's spent Q rows and stored 16 bytes a lane.
//   * What bounds it (measured on an H100, PERF.md): mma.sync in TF32
//     peaks near 320 TFLOP/s there (wgmma's dense TF32 rate is 495), so
//     3xTF32 on mma.sync does at most ~107 TFLOP/s of float32 work; the
//     rest is issue and latency at 3 blocks an SM (168 registers at D=64).
//     wgmma in TF32 takes its B operand K-major only, which for P V means
//     V transposed in shared memory: left for a later change.
//   * Training (mt_flash_attention_lse): the same kernel with LSE set also
//     writes each row's log-sum-exp, for the gradient kernels of
//     flash_attention_bwd.cu; D in {32, 64}.  ptxas gives these instances
//     the serving ones' registers (168 at D=64, 142 at D=32) and no spill.
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
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
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

// Stage `rows` rows of a row-strided [*, D] operand of T (stride in
// elements) into shared memory rows of PITCH bytes, 16 bytes a cp.async,
// with THREADS threads (thread `tid`); rows at or past `valid` are zero.
// `rows` is a multiple of the THREADS / (D * sizeof(T) / 16) rows of one
// pass, so every thread makes rows / pass copies: a count the compiler
// knows where `rows` is a constant.  The defaults are the bf16 path's:
// one warp, rows of 2D+16 bytes.
template <int D, typename T = bf16, int PITCH = 2 * D + 16, int THREADS = 32>
__device__ __forceinline__ void stage_rows(uint32_t dst, const T* src,
                                           long long stride, int rows, int valid,
                                           int tid) {
  constexpr int kChunks = D * (int)sizeof(T) / 16, kPass = THREADS / kChunks;
  const int r = tid / kChunks;
  dst += r * PITCH + (tid % kChunks) * 16;
  src += r * stride + (tid % kChunks) * (16 / (int)sizeof(T));
#pragma unroll 4
  for (int p = 0; p < rows / kPass; ++p) {
    if (r + p * kPass < valid) cp_async16(dst, src);
    else st_shared_zero16(dst);
    dst += kPass * PITCH;
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

constexpr int kWarps = 4;           // warps of a block, 16 query rows each
constexpr int kRows = 16 * kWarps;  // query rows of a block

// x -> hi + lo, both TF32 values (the low 13 bits zero): hi is x
// truncated, x - hi is exact in float32 and lo is it truncated, so hi + lo
// is x within 2^-20 relative.  Integer masks, since the kernel is
// issue-bound and cvt.rna.tf32.f32 adds a NaN check to the rounding.
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

// c += a b in 3xTF32: lo*hi and hi*lo, then hi*hi; lo*lo (under 2^-20 of
// the product) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
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

// Shared memory of one block: Q (later the output) in rows of D+8 floats,
// then a ring of two KT-key tiles (the next loads while one computes), K
// in rows of D+8 and V in rows of D+4 floats.
__host__ __device__ constexpr int tf32_smem_floats(int D, int KT) {
  return kRows * (D + 8) + 2 * KT * (2 * D + 12);
}

// One block per (b, h, kRows query rows); warp w computes rows 16w..16w+15
// of the block against KT-key tiles of K and V that all warps share.
// D <= 64 keeps the split Q in registers; D = 128 splits it from shared
// memory at each k-step.  LSE (the training instances) also writes each
// row's natural-log log-sum-exp of its scaled, masked logits to lse
// [B*H, Sq], which the backward kernels (flash_attention_bwd.cu) use to
// recompute P; the serving instances (LSE false) are the same code as
// before the flag.
template <int D, int KT, bool LSE = false>
__global__ void __launch_bounds__(kWarps * 32)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int32_t* __restrict__ kv_len,
                  float* __restrict__ o, float* __restrict__ lse, Strides st, int H, int Sq,
                  int Skv, int q_blocks, float scale_log2, int causal) {
  constexpr int kPK = D + 8;     // Q, K and output rows: 8-byte fragment loads
  constexpr int kPV = D + 4;     // V rows: scalar loads of rows 2t, 2t+1
  constexpr int kSteps = D / 8;  // k-steps of Q K^T, n-tiles of P V
  constexpr int kNT = KT / 8;    // key n-tiles of a tile, k-steps of P V
  constexpr int kStage = KT * (kPK + kPV);
  constexpr bool kQRegs = D <= 64;
  extern __shared__ __align__(16) float smem_f32[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int bh = blockIdx.x / q_blocks;
  const int b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % q_blocks) * kRows;
  const int w0 = q0 + 16 * warp;  // this warp's first row
  float* const sQ = smem_f32;
  float* const sW = sQ + 16 * warp * kPK;  // this warp's Q rows, later its output
  float* const sRing = sQ + kRows * kPK;

  const float* qg = q + b * st.qb + h * st.qh;
  const float* kg = k + b * st.kb + h * st.kh;
  const float* vg = v + b * st.vb + h * st.vh;
  float* og = o + b * st.ob + h * st.oh;

  // Row qi sees keys [0, lim(qi)); keys in [lim, Skv) are masked (-1e30)
  // and keys past Skv weigh nothing.  lim never falls as qi grows.
  const int kvl = kv_len ? max(0, min(kv_len[b], Skv)) : Skv;
  const int shift = Skv - Sq;  // bottom-right causal alignment
  auto lim = [&](int qi) { return causal ? min(kvl, max(0, qi + shift + 1)) : kvl; };
  // A fully masked row averages V over all of Skv, so a block with one
  // walks every key; otherwise the keys at or past its last row's limit
  // are masked for all its rows, and their tiles are skipped.
  const int kend = lim(q0) == 0 ? Skv : lim(min(q0 + kRows, Sq) - 1);
  const int tiles = (kend + KT - 1) / KT;
  const int lim0 = lim(w0 + g), lim1 = lim(w0 + g + 8);
  const int unmasked = lim(w0);  // keys below it are valid for all the warp's rows
  const bool active = w0 < Sq;

  auto stage_tile = [&](int it) {
    float* sK = sRing + (it & 1) * kStage;
    const int t0 = it * KT;
    stage_rows<D, float, 4 * kPK, kWarps * 32>(smem_u32(sK), kg + t0 * st.ks, st.ks, KT,
                                               kend - t0, threadIdx.x);
    stage_rows<D, float, 4 * kPV, kWarps * 32>(smem_u32(sK + KT * kPK), vg + t0 * st.vs,
                                               st.vs, KT, kend - t0, threadIdx.x);
  };
  // one cp.async group per tile (empty past the last), Q in the first;
  // kend >= 1, so there is a first tile
  stage_rows<D, float, 4 * kPK, kWarps * 32>(smem_u32(sQ), qg + q0 * st.qs, st.qs, kRows,
                                             Sq - q0, threadIdx.x);
  stage_tile(0);
  cp_async_commit();

  uint32_t qh[kQRegs ? kSteps : 1][4], ql[kQRegs ? kSteps : 1][4];
  float acc[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.0f, 0.0f};  // this lane's part; quad sum at the end

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();  // this thread's part of tile it has landed
    __syncthreads();     // every thread's part has, and tile it-1 is consumed
    if (it + 1 < tiles) stage_tile(it + 1);  // into tile it-1's stage
    cp_async_commit();
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) load_a_tf32<kPK>(sW, s, g, t, qh[s], ql[s]);
      }
    }
    if (!active) continue;
    const float* sK = sRing + (it & 1) * kStage;
    const float* sV = sK + KT * kPK;
    const int t0 = it * KT;

    // S = Q K^T; B fragment of n-tile j: key 8j+g, columns 2t, 2t+1
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t ah[4], al[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ah[e] = qh[ks][e], al[e] = ql[ks][e];
      } else {
        load_a_tf32<kPK>(sW, ks, g, t, ah, al);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 kb =
            *reinterpret_cast<const float2*>(sK + (8 * j + g) * kPK + 8 * ks + 2 * t);
        mma_3xtf32(s[j], ah, al, kb.x, kb.y);
      }
    }

    // masks and scale (log2 domain), row max over the quad; only tiles that
    // reach past `unmasked` (or Skv) hold a masked key
    const bool edge = t0 + KT > unmasked;
    float tile_max[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kj = t0 + 8 * j + 2 * t + (e & 1);
          if (kj >= (e < 2 ? lim0 : lim1)) x = kj < Skv ? kMasked : -INFINITY;
        }
        s[j][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    tile_max[0] = quad_max(tile_max[0]);
    tile_max[1] = quad_max(tile_max[1]);
    if (it > 0) {  // online rescale of what earlier tiles summed
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = fast_exp2(row_max[r] - tile_max[r]);
        row_sum[r] *= alpha;
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
      }
    }
    row_max[0] = tile_max[0];
    row_max[1] = tile_max[1];

    // O += P V.  The accumulator of n-tile j holds keys 8j+2t, 8j+2t+1 of
    // rows g, g+8, which is the A fragment of k-step j once its columns are
    // permuted as in load_a_tf32: P stays in registers.  B fragment: rows
    // 8j+2t, 8j+2t+1 of V, column g of each n-tile.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - row_max[e >> 1]);
        row_sum[e >> 1] += s[j][e];
      }
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const float* vr = sV + (8 * j + 2 * t) * kPV + g;
#pragma unroll
      for (int dn = 0; dn < kSteps; ++dn) mma_3xtf32(acc[dn], ph, pl, vr[8 * dn], vr[kPV + 8 * dn]);
    }
  }
  if (!active) return;

  // normalise, stage through this warp's spent Q rows, store 16 B a lane
  const float sum0 = quad_sum(row_sum[0]), sum1 = quad_sum(row_sum[1]);
  const float inv0 = 1.0f / sum0;
  const float inv1 = 1.0f / sum1;
  if constexpr (LSE) {  // row_max is in the log2 domain; a fully masked row's is -1e30
    if (t == 0) {
      float* lr = lse + (long long)bh * Sq;
      if (w0 + g < Sq) lr[w0 + g] = (row_max[0] + log2f(sum0)) * kLn2;
      if (w0 + g + 8 < Sq) lr[w0 + g + 8] = (row_max[1] + log2f(sum1)) * kLn2;
    }
  }
  __syncwarp();  // the warp's last reads of its Q rows are done
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    *reinterpret_cast<float2*>(sW + g * kPK + 8 * j + 2 * t) =
        make_float2(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<float2*>(sW + (g + 8) * kPK + 8 * j + 2 * t) =
        make_float2(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  __syncwarp();
  constexpr int kChunks = D / 4, kPass = 32 / kChunks;
  const int r = lane / kChunks, c = (lane % kChunks) * 4;
#pragma unroll
  for (int i = r; i < 16; i += kPass) {
    if (w0 + i < Sq)
      *reinterpret_cast<float4*>(og + (long long)(w0 + i) * st.os + c) =
          *reinterpret_cast<const float4*>(sW + i * kPK + c);
  }
}

template <int D, int KT, bool LSE = false>
int launch_tf32(const void* q, const void* k, const void* v, const void* kv_len,
                void* o, const Strides& st, int B, int H, int Sq, int Skv,
                float scale, int causal, cudaStream_t stream, void* lse = nullptr) {
  const int q_blocks = (Sq + kRows - 1) / kRows;
  const long long blocks = (long long)q_blocks * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int smem = tf32_smem_floats(D, KT) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tf32_kernel<D, KT, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_tf32_kernel<D, KT, LSE><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int32_t*)kv_len,
      (float*)o, (float*)lse, st, H, Sq, Skv, q_blocks, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 int64, the (batch, head,
// row) strides in elements of q, k, v and o.  kv_len may be null (all
// keys valid).  Rows of q, k and v must start on 16-byte boundaries.  Returns
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
  if (dtype == 0 && D == 32) return launch_tf32<32, 64>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  if (dtype == 0 && D == 64) return launch_tf32<64, 32>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  if (dtype == 0 && D == 128) return launch_tf32<128, 16>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  if (dtype == 1 && D == 32) return launch_mma<32>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  if (dtype == 1 && D == 64) return launch_mma<64>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  if (dtype == 1 && D == 128) return launch_mma<128>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The training forward: float32 only, D in {32, 64}; as mt_flash_attention,
// and also writes lse [B*H, Sq] (float32, contiguous): each row's
// natural-log log-sum-exp of its scaled, masked logits.
int mt_flash_attention_lse(const void* q, const void* k, const void* v,
                           const void* kv_len, void* o, void* lse,
                           const long long* strides, int B, int H, int Sq, int Skv,
                           int D, float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  if (Skv <= 0 || lse == nullptr) return (int)cudaErrorInvalidValue;
  Strides st;
  long long* f = &st.qb;
  for (int i = 0; i < 12; ++i) f[i] = strides[i];
  if (D == 32) return launch_tf32<32, 64, true>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s, lse);
  if (D == 64) return launch_tf32<64, 32, true>(q, k, v, kv_len, o, st, B, H, Sq, Skv, scale, causal, s, lse);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
