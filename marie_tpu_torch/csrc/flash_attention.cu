// Fused attention: softmax(Q K^T * scale + masks) V with float32
// accumulation, for q [B,H,Sq,D] and k/v [B,H,Skv,D] (float32 or bf16),
// an optional bottom-right-aligned causal mask and an optional per-batch
// kv_len right-padding mask.
//
// Replaces the TPU kernel marie_tpu/ops/pallas/flash_attention.py
// (flash_attention, kernel _flash_kernel).  On the TPU the grid walks
// (B*H, Sq/128) in order with D padded to 128, and the JAX wrapper falls
// back to plain einsum for D=64 — which every shipped model uses.  This
// kernel covers D in {32, 64, 128} (32 for the tiny test models) and any
// Sq, Skv (ragged tiles are masked).
//
// Design: one block of 4 warps per (b*h, 16-row q tile).  K/V tiles of 32
// keys are staged in shared memory as float32 (K rows padded by one word,
// so lane j reading key j is bank-conflict free).  Each warp owns 4 query
// rows; for each row lane j computes the score of key j of the tile, the
// warp reduces max and sum with shuffles (online softmax in float32
// registers), and lane d accumulates output columns d, d+32, ... with
// p_j broadcast by shuffle.  Masked keys score -1e30, exactly as the
// reference does, so a fully masked row averages V uniformly as the
// reference's softmax does; keys past Skv score -inf and weigh nothing.
// Scores, softmax and the PV sum stay in float32 for bf16 inputs too, as
// in _flash_kernel (preferred_element_type=float32); only the output is
// rounded to the input type.
//
// Bound on this card at the encoder's shape (B*H=1536, S=20, D=64): not
// bytes (~5.9 MB, ~2 us at 3.35 TB/s) nor flops (~0.5 GFLOP), but launch
// and latency: each block does 16x32 scores and one pass over 20 keys.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 16;     // query rows per block
constexpr int kBKV = 32;    // keys per shared-memory tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ kv_len,
             T* __restrict__ o, int H, int Sq, int Skv, float scale,
             int causal) {
  constexpr int DPL = D / 32;  // output columns per lane
  __shared__ float Qs[kBQ][D];
  __shared__ float Ks[kBKV][D + 1];
  __shared__ float Vs[kBKV][D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t qoff = (size_t)bh * Sq * D;
  const size_t kvoff = (size_t)bh * Skv * D;
  const int kvl = kv_len ? kv_len[bh / H] : Skv;
  const int shift = Skv - Sq;  // bottom-right causal alignment

  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    Qs[r][d] = (q0 + r < Sq) ? to_f(q[qoff + (size_t)(q0 + r) * D + d]) : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -1e30f;
    l[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[rr][c] = 0.0f;
  }

  for (int t0 = 0; t0 < Skv; t0 += kBKV) {
    __syncthreads();  // Qs written / previous tile consumed
    for (int i = threadIdx.x; i < kBKV * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const int kj = t0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kj < Skv) {
        kx = to_f(k[kvoff + (size_t)kj * D + d]);
        vx = to_f(v[kvoff + (size_t)kj * D + d]);
      }
      Ks[j][d] = kx;
      Vs[j][d] = vx;
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
        bool ok = kj < kvl;
        if (causal) ok = ok && (qi >= kj - shift);
        if (!ok) s = -1e30f;
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
    const float inv = 1.0f / (l[rr] == 0.0f ? 1.0f : l[rr]);
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      store(&o[qoff + (size_t)qi * D + lane + 32 * c], acc[rr][c] * inv);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* kv_len,
            void* o, int B, int H, int Sq, int Skv, float scale, int causal,
            cudaStream_t stream) {
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)kv_len, (T*)o,
      H, Sq, Skv, scale, causal);
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16.  kv_len may be null (all keys valid).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head width or dtype the kernel does not take.
int mt_flash_attention(const void* q, const void* k, const void* v,
                       const void* kv_len, void* o, int B, int H, int Sq,
                       int Skv, int D, int dtype, float scale, int causal,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  if (Skv <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 32) launch<float, 32>(q, k, v, kv_len, o, B, H, Sq, Skv, scale, causal, s);
  else if (dtype == 0 && D == 64) launch<float, 64>(q, k, v, kv_len, o, B, H, Sq, Skv, scale, causal, s);
  else if (dtype == 0 && D == 128) launch<float, 128>(q, k, v, kv_len, o, B, H, Sq, Skv, scale, causal, s);
  else if (dtype == 1 && D == 32) launch<__nv_bfloat16, 32>(q, k, v, kv_len, o, B, H, Sq, Skv, scale, causal, s);
  else if (dtype == 1 && D == 64) launch<__nv_bfloat16, 64>(q, k, v, kv_len, o, B, H, Sq, Skv, scale, causal, s);
  else if (dtype == 1 && D == 128) launch<__nv_bfloat16, 128>(q, k, v, kv_len, o, B, H, Sq, Skv, scale, causal, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
