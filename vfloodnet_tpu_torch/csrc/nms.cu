// Greedy non-maximum suppression with a static output size, on the card.
//
// Replaces vfloodnet_tpu/ops/nms.py::nms (an XLA fori_loop in the JAX
// package, not a Pallas kernel), which the detector runs twice an image:
// the RPN's (about 4,756 boxes, IoU 0.7, 1,000 kept, logits > 0) and the
// box head's class-aware one (2,048 candidates, IoU 0.5, 100 kept). The
// port's plain version (ops/nms.py::nms_plain) is that loop: max_out steps
// of some ten small launches each, about 11,000 launches an image, which
// cost more than the work.
//
// The same result in three launches and no host sync:
//   1. rank:  every box's key, (score's ordered bits << 32 | ~index) for a
//             box alive (score > score_threshold), 0 << 32 | ~index for a
//             dead one; its rank is the number of larger keys, so
//             order[rank] = index sorts by score descending, index
//             ascending, alive boxes first. One thread per box, keys
//             streamed through shared memory.
//   2. mask:  for sorted positions i < j, bit j of row i is set when
//             IoU(box i, box j) > iou_threshold: 64 x 64 tiles, one block
//             each, one row per thread, 64-bit words. The IoU is the plain
//             version's float32 arithmetic in its order (clip, products,
//             union, / max(union, 1e-9)) with rounded intrinsics, so no
//             product is contracted into an FMA and the bits are the plain
//             version's.
//   3. walk:  one block counts the alive boxes, then walks the sorted list
//             64 positions at a time: warp 0 takes the positions of a chunk
//             in order, keeping each one not yet removed and OR-ing its
//             row's word of this chunk (fetched by shuffle) into the
//             removed bits; then the whole block ORs the kept rows into the
//             removed words of the later chunks. It stops at max_out kept.
//             An alive score of +inf ends the plain loop at its first step
//             (its isfinite check), so it keeps nothing here too.
// Outputs: keep_idx (int64, 0 where absent), keep_scores (-inf where
// absent) and valid, as the plain version returns them.
//
// Bound: the boxes and scores in and the max_out outputs out are tens of
// kilobytes, nanoseconds at the memory rate. The operations greedy NMS
// needs are the IoUs of each pick with the boxes still alive at its step,
// 20 float32 operations each (1.69 M pairs at the RPN's shape in
// chip_smoke.py): half a microsecond at the float32 rate. This kernel
// computes every pair's IoU (N^2 / 2) to build the mask in parallel, and
// its walk is serial in 64-box chunks, so it runs at launch and memory
// latency, hundreds of times its bound; a simple kernel that is right
// comes first.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRankThreads = 256;
constexpr int kTile = 64;
constexpr int kWalkThreads = 256;

__device__ __forceinline__ unsigned long long sort_key(float s, int i,
                                                       float score_thr) {
  const unsigned long long low = 0xffffffffull - (unsigned)i;
  if (!(s > score_thr)) return low;             // dead: below every alive key
  if (s == 0.0f) s = 0.0f;                      // -0 orders as +0
  const unsigned u = __float_as_uint(s);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | low;
}

__global__ void nms_rank_kernel(const float* __restrict__ scores, int n,
                                float score_thr, int* __restrict__ order) {
  __shared__ unsigned long long tile[kRankThreads];
  const int i = blockIdx.x * kRankThreads + threadIdx.x;
  const unsigned long long mine = i < n ? sort_key(scores[i], i, score_thr)
                                        : 0ull;
  int rank = 0;
  for (int base = 0; base < n; base += kRankThreads) {
    const int j = base + threadIdx.x;
    // padding keys are 0, below every key of a box
    tile[threadIdx.x] = j < n ? sort_key(scores[j], j, score_thr) : 0ull;
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kRankThreads; ++t) rank += tile[t] > mine;
    __syncthreads();
  }
  if (i < n) order[rank] = i;
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// IoU of a (the earlier pick) with b, as ops/nms.py::box_iou computes it
__device__ __forceinline__ float iou_of(float4 a, float area_a, float4 b,
                                        float area_b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes,
                                const int* __restrict__ order, int n,
                                int words, float iou_thr,
                                unsigned long long* __restrict__ mask) {
  const int row_tile = blockIdx.y, col_tile = blockIdx.x;
  const int t = threadIdx.x;
  const int row = row_tile * kTile + t;
  if (col_tile < row_tile) {                    // below the diagonal
    if (row < n) mask[(size_t)row * words + col_tile] = 0ull;
    return;
  }
  __shared__ float4 cols[kTile];
  __shared__ float col_area[kTile];
  const int col = col_tile * kTile + t;
  if (col < n) {
    const float4 b = boxes[order[col]];
    cols[t] = b;
    col_area[t] = area_of(b);
  }
  __syncthreads();
  if (row >= n) return;
  const float4 a = boxes[order[row]];
  const float area_a = area_of(a);
  const int n_cols = min(kTile, n - col_tile * kTile);
  unsigned long long bits = 0ull;
  for (int c = 0; c < n_cols; ++c) {
    if (col_tile * kTile + c <= row) continue;
    if (iou_of(a, area_a, cols[c], col_area[c]) > iou_thr)
      bits |= 1ull << c;
  }
  mask[(size_t)row * words + col_tile] = bits;
}

__global__ void nms_walk_kernel(const float* __restrict__ scores,
                                const int* __restrict__ order,
                                const unsigned long long* __restrict__ mask,
                                int n, int words, float score_thr,
                                int max_out, long long* __restrict__ keep_idx,
                                float* __restrict__ keep_scores,
                                bool* __restrict__ valid) {
  extern __shared__ unsigned long long removed[];
  __shared__ int s_alive, s_count, s_kept_n;
  __shared__ int kept[kTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_alive = 0;
    s_count = 0;
  }
  for (int w = tid; w < words; w += kWalkThreads) removed[w] = 0ull;
  __syncthreads();
  int alive = 0;
  for (int i = tid; i < n; i += kWalkThreads) alive += scores[i] > score_thr;
  atomicAdd(&s_alive, alive);
  __syncthreads();
  int m = s_alive;
  if (m > 0 && isinf(scores[order[0]])) m = 0;  // the plain loop stops
  int count = 0;
  for (int c = 0; c * kTile < m; ++c) {
    if (warp == 0) {
      unsigned long long word = removed[c];
      const int r0 = c * kTile + lane, r1 = r0 + 32;
      const unsigned long long row_a =
          r0 < m ? mask[(size_t)r0 * words + c] : 0ull;
      const unsigned long long row_b =
          r1 < m ? mask[(size_t)r1 * words + c] : 0ull;
      const int end = min(kTile, m - c * kTile);
      int kept_n = 0, cnt = count;
      for (int b = 0; b < end && cnt < max_out; ++b) {
        const unsigned long long r =
            __shfl_sync(0xffffffffu, b < 32 ? row_a : row_b, b & 31);
        if ((word >> b) & 1ull) continue;
        const int pos = c * kTile + b;
        if (lane == 0) {
          const int idx = order[pos];
          kept[kept_n] = pos;
          keep_idx[cnt] = idx;
          keep_scores[cnt] = scores[idx];
          valid[cnt] = true;
        }
        ++kept_n;
        ++cnt;
        word |= r;
      }
      if (lane == 0) {
        s_kept_n = kept_n;
        s_count = cnt;
      }
    }
    __syncthreads();
    count = s_count;
    const int kept_n = s_kept_n;
    if (count >= max_out) break;
    for (int w = c + 1 + tid; w < words; w += kWalkThreads) {
      unsigned long long acc = 0ull;
      for (int k = 0; k < kept_n; ++k)
        acc |= mask[(size_t)kept[k] * words + w];
      removed[w] |= acc;
    }
    __syncthreads();
  }
  for (int k = count + tid; k < max_out; k += kWalkThreads) {
    keep_idx[k] = 0;
    keep_scores[k] = -INFINITY;
    valid[k] = false;
  }
}

}  // namespace

extern "C" {

// Words of the suppression mask a row (64 sorted boxes a word).
int vft_nms_words(int n) { return (n + kTile - 1) / kTile; }

// boxes [n, 4] float32 xyxy, scores [n] float32; scratch: order [n] int32,
// mask [n, words] uint64; outputs keep_idx [max_out] int64, keep_scores
// [max_out] float32, valid [max_out] bool. n >= 1, max_out >= 1.
int vft_nms(const float* boxes, const float* scores, int n, float iou_thr,
            float score_thr, int max_out, int* order,
            unsigned long long* mask, long long* keep_idx,
            float* keep_scores, bool* valid, cudaStream_t stream) {
  if (n < 1 || max_out < 1) return (int)cudaErrorInvalidValue;
  const int words = vft_nms_words(n);
  if ((size_t)words * sizeof(unsigned long long) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  nms_rank_kernel<<<(n + kRankThreads - 1) / kRankThreads, kRankThreads, 0,
                    stream>>>(scores, n, score_thr, order);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_mask_kernel<<<dim3(words, words), kTile, 0, stream>>>(
      reinterpret_cast<const float4*>(boxes), order, n, words, iou_thr, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_walk_kernel<<<1, kWalkThreads, words * sizeof(unsigned long long),
                    stream>>>(scores, order, mask, n, words, score_thr,
                              max_out, keep_idx, keep_scores, valid);
  return (int)cudaGetLastError();
}

const char* vft_nms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
