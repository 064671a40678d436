// Largest 8-connected component of a batch of binary maps, on the card.
//
// Replaces vfloodnet_tpu/ops/cc.py::largest_connected_component (an XLA
// while_loop of label-propagation sweeps in the JAX package, not a Pallas
// kernel), which the video step runs on its 1/16 grid (about 30 x 54
// cells at the 480 operating point) and the image path on 416 x 416 maps.
// The port's plain version (ops/cc.py) iterates to a fixpoint with host
// checks; a loop whose length depends on the data cannot live in a CUDA
// graph, and its launches and syncs, not its work, were its cost.
//
// Union-find in a fixed number of launches, every map of the batch at
// once, one thread per pixel:
//   1. init:     parent[i] = i on foreground, -1 on background; size = 0;
//                best = 0.
//   2. merge:    each foreground pixel unites with its foreground
//                neighbours above and to the left (W, NW, N, NE), which
//                covers every 8-neighbour pair once. Roots are linked with
//                atomicMin, always the larger root under the smaller, so
//                every root is the smallest raster index of its component:
//                the label the JAX op gives.
//   3. compress: parent[i] = root(i); size[root] += 1.
//   4. argmax:   each root offers (size << 32 | ~root) to its map's best
//                with atomicMax: the largest size, ties to the smaller
//                root, as the JAX op's argmax over sorted labels.
//   5. keep:     keep[i] = foreground and parent[i] is the best root.
// An empty map keeps nothing. Nothing synchronises with the host.
//
// Bound: the bytes of the mask in and the keep mask out (the scratch
// stays in L2 at these sizes); at the video step's 1,590 cells that is
// nanoseconds, so the five launches are the cost, which a graph replay
// keeps off the host.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const int* parent, int x) {
  // parents only ever decrease towards the root; a stale read is still on
  // the path to it
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  bool done;
  do {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a < b) {
      const int old = atomicMin(parent + b, a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(parent + a, b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void cc_init_kernel(const uint8_t* __restrict__ mask,
                               int* __restrict__ parent,
                               int* __restrict__ size,
                               unsigned long long* __restrict__ best,
                               long long total, int hw, int maps) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(t % hw);
    parent[t] = mask[t] ? i : -1;
    size[t] = 0;
    if (t < maps) best[t] = 0ull;
  }
}

__global__ void cc_merge_kernel(int* __restrict__ parent, long long total,
                                int h, int w) {
  const int hw = h * w;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    int* p = parent + (t / hw) * hw;
    const int i = (int)(t % hw);
    if (p[i] < 0) continue;
    const int y = i / w, x = i % w;
    if (x > 0 && p[i - 1] >= 0) unite(p, i, i - 1);
    if (y > 0) {
      const int up = i - w;
      if (x > 0 && p[up - 1] >= 0) unite(p, i, up - 1);
      if (p[up] >= 0) unite(p, i, up);
      if (x + 1 < w && p[up + 1] >= 0) unite(p, i, up + 1);
    }
  }
}

__global__ void cc_compress_kernel(int* __restrict__ parent,
                                   int* __restrict__ size, long long total,
                                   int hw) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long base = (t / hw) * hw;
    const int i = (int)(t - base);
    if (parent[t] < 0) continue;
    const int root = find_root(parent + base, i);
    parent[t] = root;
    atomicAdd(size + base + root, 1);
  }
}

__global__ void cc_argmax_kernel(const int* __restrict__ parent,
                                 const int* __restrict__ size,
                                 unsigned long long* __restrict__ best,
                                 long long total, int hw) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(t % hw);
    if (parent[t] != i) continue;   // background or not a root
    const unsigned long long key =
        ((unsigned long long)(unsigned)size[t] << 32) |
        (unsigned long long)(0xffffffffu - (unsigned)i);
    atomicMax(best + t / hw, key);
  }
}

__global__ void cc_keep_kernel(const int* __restrict__ parent,
                               const unsigned long long* __restrict__ best,
                               uint8_t* __restrict__ keep, long long total,
                               int hw) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const unsigned long long b = best[t / hw];
    const int root = (int)(0xffffffffu - (unsigned)(b & 0xffffffffull));
    keep[t] = (b != 0ull && parent[t] == root) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// mask, keep: [maps, h, w] uint8; parent, size: [maps, h, w] int32
// scratch; best: [maps] uint64 scratch. Five launches on `stream`.
int vft_largest_cc(const void* mask, void* parent, void* size, void* best,
                   void* keep, int maps, int h, int w, void* stream) {
  const long long total = (long long)maps * h * w;
  if (total == 0) return 0;
  const int hw = h * w;
  cudaStream_t s = (cudaStream_t)stream;
  long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 65535 ? want : 65535);
  int* par = (int*)parent;
  int* sz = (int*)size;
  unsigned long long* bst = (unsigned long long*)best;
  cc_init_kernel<<<blocks, kThreads, 0, s>>>((const uint8_t*)mask, par, sz,
                                             bst, total, hw, maps);
  cc_merge_kernel<<<blocks, kThreads, 0, s>>>(par, total, h, w);
  cc_compress_kernel<<<blocks, kThreads, 0, s>>>(par, sz, total, hw);
  cc_argmax_kernel<<<blocks, kThreads, 0, s>>>(par, sz, bst, total, hw);
  cc_keep_kernel<<<blocks, kThreads, 0, s>>>(par, bst, (uint8_t*)keep,
                                             total, hw);
  return (int)cudaGetLastError();
}

const char* vft_cc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
