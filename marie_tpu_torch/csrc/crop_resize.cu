// Word-crop kernel: aspect-preserving bilinear crop+resize of N boxes out
// of a uint8 grayscale page stack.
//
// Replaces the TPU kernel marie_tpu/ops/pallas/crop_resize.py
// (crop_resize_pallas, kernel _kernel).  That kernel DMAs a 224-row slab
// per crop and resamples it with two small matmuls; a box taller than the
// slab is clamped to its top, so the JAX caller routes such batches to
// the gather path.  Here each output row reads its own two source rows,
// with no window, so the result is exact for boxes of any height and no
// fallback exists.
//
// Bound on this card: bytes.  The work is 4 page taps, ~23 flops and one
// float32 store per output pixel; the store (N*out_h*out_w*4 bytes, 15.7
// MB for 256 crops of 48x320) is ~91% of the bytes.  The design:
//   * grid (crop, group of kRows output rows): 6 blocks per 48-row crop,
//     1,536 for 256 crops, all resident at once (~12 per SM);
//   * a block stages the two source rows of each of its output rows,
//     over the columns its taps reach, in shared memory with 4-byte
//     cp.async, every copy in flight at once (taps read straight from
//     the page wait on L1/L2 row by row and measured slower at the
//     slice's shapes; splitting the copies into two groups to overlap
//     the first rows' arithmetic gained nothing);
//   * each thread owns 4 consecutive output columns and loops over the
//     block's rows.  Its column taps (x0, x1, lx, 1-lx, and whether the
//     column is past eff_w) are computed once, in registers; a row's taps
//     once per row.  Hoisting reorders no float operation;
//   * the 4 pixels leave as one 16-byte float4 store when out_w % 4 == 0
//     (every row then starts 16-byte aligned), else as scalar stores.
//     White columns past eff_w are selected, not branched around (the
//     branch cost registers and measured slower).
// Registers (nvcc -Xptxas -v, sm_90a): printed by chip_smoke.py's device
// phase; see PERF.md.
//
// The arithmetic is the plain version's
// (marie_tpu_torch/preprocess/ops.py::crop_resize_pages), operation for
// operation, so the two agree to the bit: divides by constants are
// multiplies by float32 reciprocals, a * b + c is one fused multiply-add,
// out_h / bh is a true divide.
//
// channel_mean != 0 (the CRNN's crops; its own instance of the kernel,
// so the other crops run the code they ran before): each pixel is the
// mean of the crop of the page expanded to three equal channels, as
// XLA's CPU backend fuses the JAX version's crop, scale and channel
// mean: the scale contracts into the sum, ((v * s) fma v * s) fma v * s,
// and the sum is multiplied by float32(1/3).  That is not v * s for
// about a third of the pixels, so it cannot be taken from the scaled
// crop.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRows = 8;  // output rows per block

// Column c's taps x0, x1 (clamped to the page) and weight lx.
__device__ __forceinline__ void column_taps(int c, float step, float bx0, int W,
                                            int& x0, int& x1, float& lx) {
  float sx = __fsub_rn(__fmaf_rn(__fadd_rn((float)c, 0.5f), step, bx0), 0.5f);
  sx = fminf(fmaxf(sx, 0.0f), (float)(W - 1));
  x0 = (int)floorf(sx);
  x1 = min(x0 + 1, W - 1);
  lx = __fsub_rn(sx, (float)x0);
}

// Copy bytes [lo, lo + 4 * words) of the source row of each of `slots`
// slots into its shared row (one warp per row) and wait for them:
// 4-byte cp.async for 4-byte aligned rows, plain loads otherwise.
__device__ __forceinline__ void stage_rows(uint8_t* srows, int pitch, const int* ys,
                                           int slots, const uint8_t* page, int W,
                                           int lo, int words) {
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int slot = threadIdx.x >> 5; slot < slots; slot += warps) {
    const uint8_t* src = page + (size_t)ys[slot] * W + lo;
    uint8_t* dst = srows + slot * pitch;
    if ((W & 3) == 0) {
      for (int i = lane; i < words; i += 32) {
        const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + 4 * i);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src + 4 * i)
                     : "memory");
      }
    } else {
      for (int i = lane; i < min(4 * words, W - lo); i += 32) dst[i] = __ldg(src + i);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <bool kChannelMean>
__global__ void crop_resize_kernel(
    const uint8_t* __restrict__ pages,   // [P, H, W]
    const int32_t* __restrict__ page_of, // [N]
    const float* __restrict__ boxes,     // [N, 4] xyxy
    float* __restrict__ crops,           // [N, out_h, out_w]
    int32_t* __restrict__ eff_w_out,     // [N]
    int P, int H, int W, int out_h, int out_w, int pitch) {
  extern __shared__ __align__(16) uint8_t srows[];  // [2 * kRows][pitch]
  __shared__ int ys[2 * kRows];                     // source row of each slot
  __shared__ float lys[kRows];
  const int n = blockIdx.x;
  const float inv_oh = (float)(1.0 / out_h);
  const float inv_ow = (float)(1.0 / out_w);
  const float inv_255 = (float)(1.0 / 255.0);
  const float bx0 = __ldg(boxes + 4 * n + 0);
  const float by0 = __ldg(boxes + 4 * n + 1);
  const float bx1 = __ldg(boxes + 4 * n + 2);
  const float by1 = __ldg(boxes + 4 * n + 3);
  const float bh = fmaxf(__fsub_rn(by1, by0), 1.0f);
  const float bw = fmaxf(__fsub_rn(bx1, bx0), 1.0f);
  const float scale = __fdiv_rn((float)out_h, bh);
  const float eff_w = fminf(rintf(__fmul_rn(bw, scale)), (float)out_w);
  const float step = fmaxf(__fmul_rn(bh, inv_oh), __fmul_rn(bw, inv_ow));
  int p = __ldg(page_of + n);
  p = p < 0 ? 0 : (p >= P ? P - 1 : p);
  const uint8_t* page = pages + (size_t)p * H * W;
  if (blockIdx.y == 0 && threadIdx.x == 0) eff_w_out[n] = (int32_t)eff_w;
  const float white = __fmul_rn(255.0f, inv_255);
  const int r0 = blockIdx.y * kRows;
  const int rows = min(out_h, r0 + kRows) - r0;

  // row taps of the block's rows: slot 2i holds row i's y0, slot 2i+1 its y1
  if (threadIdx.x < rows) {
    const float ys_frac = __fmul_rn(__fadd_rn((float)(r0 + threadIdx.x), 0.5f), inv_oh);
    float sy = __fsub_rn(__fmaf_rn(ys_frac, bh, by0), 0.5f);
    sy = fminf(fmaxf(sy, 0.0f), (float)(H - 1));
    const int y0 = (int)floorf(sy);
    ys[2 * threadIdx.x] = y0;
    ys[2 * threadIdx.x + 1] = min(y0 + 1, H - 1);
    lys[threadIdx.x] = __fsub_rn(sy, (float)y0);
  }
  // the byte span the taps reach: x0 of column 0 .. x1 of the last sampled one
  const int sampled = min((int)eff_w, out_w);
  int lo = 0, words = 0;
  if (sampled > 0) {
    int first, last, unused;
    float l;
    column_taps(0, step, bx0, W, first, unused, l);
    column_taps(sampled - 1, step, bx0, W, unused, last, l);
    lo = first & ~3;
    words = (last - lo) / 4 + 1;
  }
  __syncthreads();
  stage_rows(srows, pitch, ys, 2 * rows, page, W, lo, words);
  __syncthreads();
  const int c0 = 4 * threadIdx.x;
  if (c0 >= out_w) return;

  // column taps of this thread's 4 columns, as offsets into a staged row
  // (0 for white columns, whose taps may lie outside the staged span)
  int ox0[4], ox1[4];
  float lx[4], olx[4];
  bool pad[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int x0, x1;
    pad[j] = (float)(c0 + j) >= eff_w;
    column_taps(c0 + j, step, bx0, W, x0, x1, lx[j]);
    olx[j] = __fsub_rn(1.0f, lx[j]);
    ox0[j] = pad[j] ? 0 : x0 - lo;
    ox1[j] = pad[j] ? 0 : x1 - lo;
  }
  const bool vec = (out_w & 3) == 0;

  for (int i = 0; i < rows; ++i) {
    const float ly = lys[i];
    const float oly = __fsub_rn(1.0f, ly);
    const uint8_t* s0 = srows + 2 * i * pitch;
    const uint8_t* s1 = s0 + pitch;
    float px[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a00 = (float)s0[ox0[j]];
      const float a01 = (float)s0[ox1[j]];
      const float a10 = (float)s1[ox0[j]];
      const float a11 = (float)s1[ox1[j]];
      const float cx0 = __fmaf_rn(a00, oly, __fmul_rn(a10, ly));  // rows at x0
      const float cx1 = __fmaf_rn(a01, oly, __fmul_rn(a11, ly));  // rows at x1
      if constexpr (kChannelMean) {
        const float v = pad[j] ? 255.0f : __fmaf_rn(cx0, olx[j], __fmul_rn(cx1, lx[j]));
        const float sum = __fmaf_rn(v, inv_255, __fmaf_rn(v, inv_255, __fmul_rn(v, inv_255)));
        px[j] = __fmul_rn(sum, (float)(1.0 / 3.0));
      } else {
        const float v = __fmaf_rn(cx0, olx[j], __fmul_rn(cx1, lx[j]));
        px[j] = pad[j] ? white : __fmul_rn(v, inv_255);
      }
    }
    float* out = crops + ((size_t)n * out_h + r0 + i) * out_w + c0;
    if (vec) {
      *reinterpret_cast<float4*>(out) = make_float4(px[0], px[1], px[2], px[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < out_w) out[j] = px[j];
    }
  }
}

}  // namespace

extern "C" {

const char* mt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch on `stream`; returns cudaGetLastError() after the launch.
int mt_crop_resize(const void* pages, const void* page_of, const void* boxes,
                   void* crops, void* eff_w, int N, int P, int H, int W,
                   int out_h, int out_w, int channel_mean, void* stream) {
  if (N > 0) {
    const int threads = std::max(32, ((out_w + 3) / 4 + 31) / 32 * 32);
    const dim3 grid(N, std::max(1, (out_h + kRows - 1) / kRows));
    const int pitch = (W + 8 + 15) & ~15;  // a staged row, 16-byte aligned
    const int smem = 2 * kRows * pitch;
    const auto kernel = channel_mean ? crop_resize_kernel<true> : crop_resize_kernel<false>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)pages, (const int32_t*)page_of, (const float*)boxes,
        (float*)crops, (int32_t*)eff_w, P, H, W, out_h, out_w, pitch);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
