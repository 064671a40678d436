// Peak TF32 tensor-core rates of the two instruction paths on a Hopper card:
// mma.sync.m16n8k8 (registers; what csrc/bank_read.cu uses) and
// wgmma.mma_async m64n128k8 (shared-memory operands). Each kernel keeps
// independent accumulators busy with no loads, on 16 warps per SM, and
// times itself with CUDA events. The wgmma operands are a zeroed tile
// behind a plain (unswizzled) descriptor: the rate does not depend on the
// values. Built and run by scripts/probe_tf32_rates.py.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) mma_sync_rate(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4];
  const uint32_t b0 = threadIdx.x & 0xffffe000u, b1 = (threadIdx.x * 3) & 0xffffe000u;
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x * (i + 1)) & 0xffffe000u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = (uint64_t)__cvta_generic_to_shared(p);
  return ((addr >> 4) & 0x3fff) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__global__ void __launch_bounds__(256) wgmma_rate(float* out, int iters) {
  __shared__ __align__(1024) float sa[64 * 16];
  __shared__ __align__(1024) float sb[128 * 16];
  for (int i = threadIdx.x; i < 64 * 16; i += blockDim.x) sa[i] = 0.f;
  for (int i = threadIdx.x; i < 128 * 16; i += blockDim.x) sb[i] = 0.f;
  __syncthreads();
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const uint64_t da = smem_desc(sa), db = smem_desc(sb);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "l"(da), "l"(db), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = 2 * sms;   // 2 blocks of 8 warps on each SM
  float* out = nullptr;
  cudaMalloc(&out, (size_t)blocks * 256 * sizeof(float));
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float ms = 0.f;
  const int it_sync = 4096, it_wg = 1024;
  mma_sync_rate<<<blocks, 256>>>(out, 16);
  cudaEventRecord(a);
  mma_sync_rate<<<blocks, 256>>>(out, it_sync);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  cudaEventElapsedTime(&ms, a, b);
  const double f_sync = (double)blocks * 8 * it_sync * 8 * (16.0 * 8 * 8 * 2);
  printf("{\"mma_sync_m16n8k8_tf32_tflops\": %.1f, ", f_sync / ms / 1e9);
  wgmma_rate<<<blocks, 256>>>(out, 4);
  cudaEventRecord(a);
  wgmma_rate<<<blocks, 256>>>(out, it_wg);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  cudaEventElapsedTime(&ms, a, b);
  const double f_wg = (double)blocks * 2 * it_wg * 8 * (64.0 * 128 * 8 * 2);
  printf("\"wgmma_m64n128k8_tf32_tflops\": %.1f, \"error\": \"%s\"}\n",
         f_wg / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
