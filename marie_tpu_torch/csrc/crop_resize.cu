// Word-crop kernel: aspect-preserving bilinear crop+resize of N boxes out
// of a uint8 grayscale page stack.
//
// Replaces the TPU kernel marie_tpu/ops/pallas/crop_resize.py
// (crop_resize_pallas, kernel _kernel).  That kernel DMAs a 224-row slab
// per crop and resamples it with two small matmuls; a box taller than the
// slab is clamped to its top, so the JAX caller routes such batches to
// the gather path.  Here one block cuts one crop and each thread computes
// output pixels directly: an output row reads its two source rows from
// the page itself, with no window, so the result is exact for boxes of
// any height and no fallback exists.
//
// Bound on this card: bytes.  The work is 4 page reads, ~10 flops and
// one float32 store per output pixel; the store (N*out_h*out_w*4 bytes)
// dominates.  Neighbouring threads write neighbouring output pixels
// (coalesced stores); page reads go through L1/L2, where a crop's few
// source rows stay resident.
//
// The arithmetic is the plain version's
// (marie_tpu_torch/preprocess/ops.py::crop_resize_pages), operation for
// operation, so the two agree to the bit: divides by constants are
// multiplies by float32 reciprocals, a * b + c is one fused multiply-add,
// out_h / bh is a true divide.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void crop_resize_kernel(
    const uint8_t* __restrict__ pages,   // [P, H, W]
    const int32_t* __restrict__ page_of, // [N]
    const float* __restrict__ boxes,     // [N, 4] xyxy
    float* __restrict__ crops,           // [N, out_h, out_w]
    int32_t* __restrict__ eff_w_out,     // [N]
    int P, int H, int W, int out_h, int out_w) {
  const int n = blockIdx.x;
  const float inv_oh = (float)(1.0 / out_h);
  const float inv_ow = (float)(1.0 / out_w);
  const float inv_255 = (float)(1.0 / 255.0);
  const float bx0 = boxes[4 * n + 0];
  const float by0 = boxes[4 * n + 1];
  const float bx1 = boxes[4 * n + 2];
  const float by1 = boxes[4 * n + 3];
  const float bh = fmaxf(__fsub_rn(by1, by0), 1.0f);
  const float bw = fmaxf(__fsub_rn(bx1, bx0), 1.0f);
  const float scale = __fdiv_rn((float)out_h, bh);
  const float eff_w = fminf(rintf(__fmul_rn(bw, scale)), (float)out_w);
  const float step = fmaxf(__fmul_rn(bh, inv_oh), __fmul_rn(bw, inv_ow));
  int p = page_of[n];
  p = p < 0 ? 0 : (p >= P ? P - 1 : p);
  const uint8_t* page = pages + (size_t)p * H * W;
  float* out = crops + (size_t)n * out_h * out_w;
  if (threadIdx.x == 0) eff_w_out[n] = (int32_t)eff_w;
  const float white = __fmul_rn(255.0f, inv_255);

  const int total = out_h * out_w;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / out_w;
    const int c = i - r * out_w;
    if ((float)c >= eff_w) {
      out[i] = white;
      continue;
    }
    const float ys_frac = __fmul_rn(__fadd_rn((float)r, 0.5f), inv_oh);
    float sy = __fsub_rn(__fmaf_rn(ys_frac, bh, by0), 0.5f);
    sy = fminf(fmaxf(sy, 0.0f), (float)(H - 1));
    float sx = __fsub_rn(__fmaf_rn(__fadd_rn((float)c, 0.5f), step, bx0), 0.5f);
    sx = fminf(fmaxf(sx, 0.0f), (float)(W - 1));
    const int y0 = (int)floorf(sy);
    const int y1 = min(y0 + 1, H - 1);
    const int x0 = (int)floorf(sx);
    const int x1 = min(x0 + 1, W - 1);
    const float ly = __fsub_rn(sy, (float)y0);
    const float lx = __fsub_rn(sx, (float)x0);
    const float oly = __fsub_rn(1.0f, ly);
    const float olx = __fsub_rn(1.0f, lx);
    const float a00 = (float)page[(size_t)y0 * W + x0];
    const float a01 = (float)page[(size_t)y0 * W + x1];
    const float a10 = (float)page[(size_t)y1 * W + x0];
    const float a11 = (float)page[(size_t)y1 * W + x1];
    const float c0 = __fmaf_rn(a00, oly, __fmul_rn(a10, ly));  // rows at x0
    const float c1 = __fmaf_rn(a01, oly, __fmul_rn(a11, ly));  // rows at x1
    const float v = __fmaf_rn(c0, olx, __fmul_rn(c1, lx));
    out[i] = __fmul_rn(v, inv_255);
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
                   int out_h, int out_w, void* stream) {
  if (N > 0) {
    crop_resize_kernel<<<N, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pages, (const int32_t*)page_of, (const float*)boxes,
        (float*)crops, (int32_t*)eff_w, P, H, W, out_h, out_w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
