// The card's rate of mma.sync.m16n8k8 in TF32 with float32 accumulators:
// each warp keeps 8 independent accumulators, so the tensor cores, not the
// MMA latency, are the limit.  The ceiling of a kernel built on mma.sync
// (csrc/flash_attention.cu's float32 path, which spends three of these
// per product).  Built and timed by scripts/kernel_times.py --mma-rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;

__global__ void mma_tf32_loop(float* out, int iters) {
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i)) & 0xffffe000u;
  float c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[0]), "r"(a[1]));
  }
  float s = 0.0f;
  for (int j = 0; j < kChains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// Flops of one launch of mt_mma_tf32_loop(out, blocks, threads, iters).
double mt_mma_tf32_flops(int blocks, int threads, int iters) {
  return (double)blocks * (threads / 32) * iters * kChains * 2.0 * 16 * 8 * 8;
}

// out: blocks * threads floats.  Returns cudaGetLastError().
int mt_mma_tf32_loop(float* out, int blocks, int threads, int iters, void* stream) {
  mma_tf32_loop<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
