// Memory read and usage count over the feature bank, for Hopper (sm_90a).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (vfloodnet_tpu_torch/ops/bank_read_cuda.py). Both kernels run
// in float32 on the CUDA cores, launch on the caller's stream, allocate
// nothing, and return cudaGetLastError() from their launch function.
//
// Shapes (row-major, contiguous):
//   q          [P, DK]            query pixels of the current frame
//   k          [obj, N, DK]       bank keys
//   v          [obj, N, DV]       bank values
//   valid      [obj, N] uint8     slot validity
//   occ_bound  [1] int32 or NULL  occupancy bound, read on the device
//   mem        [obj, P, DV], m and l [obj, P]     (read outputs)
//   log_thres  [obj, P] -> cnt [obj, N] float32   (count)
//
// Occupancy bound (the semantics of vfloodnet_tpu/ops/attention.py
// _xla_read_occ): with c = min(chunk, N), only the first
// clip(ceil(occ/c), 1, ceil(N/c)) chunks of c slots are visited. Slots in a
// visited chunk at index >= N are zero padding and count as invalid; the
// valid mask still applies inside every visited chunk. The bound is read
// from device memory so that a step never waits on the host. Without a
// bound every one of the N slots is visited.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int DK = 128;
constexpr int DV = 512;
constexpr float NEG = -1e30f;   // masked score, as in the JAX kernels
constexpr int KPAD = DK + 4;    // shared-memory row stride of q and k tiles

__device__ __forceinline__ int visited_slots(const int* occ_bound, int n,
                                             int chunk) {
  if (occ_bound == nullptr) return n;
  const int c = min(chunk, n);
  const int n_chunks = (n + c - 1) / c;
  const int occ = max(*occ_bound, 0);
  const int it = max(1, min((occ + c - 1) / c, n_chunks));
  return it * c;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Copies rows [row0, row0 + rows) of a [*, width] matrix into shared memory
// with row stride `stride`; rows at or beyond `limit` are written as zeros.
template <int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int width,
                                          int stride, int limit) {
  const int w4 = width / 4;
  for (int i = threadIdx.x; i < rows * w4; i += THREADS) {
    const int r = i / w4, c4 = i % w4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit)
      val = reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * width)[c4];
    *reinterpret_cast<float4*>(dst + r * stride + c4 * 4) = val;
  }
}

// ---------------------------------------------------------------------------
// Read kernel. Replaces _read_kernel, vfloodnet_tpu/ops/attention_pallas.py.
//
//   mem[p] = sum_n softmax_n(q_p . k_n / sqrt(DK)) v_n,  m[p], l[p]
//
// What bounds it: operations. Per object it does 2 P N (DK + DV) flop on
// P N DK + N (DK + DV) input floats; at P = 1620 the work per byte of bank
// is far above the card's balance point, so the float32 FMA rate is the
// limit, not device memory.
//
// Design: the TPU kernel walks the bank on a sequential grid axis with its
// running max, normaliser and accumulator in VMEM scratch. Here one block
// owns (object, 16 query rows) and walks the visited bank in tiles of 32
// slots with a loop, so the running max m, normaliser l and the 16 x 512
// float32 accumulator stay in registers for the whole bank: no [P, N]
// score matrix and no partial results ever reach device memory. Each tile of
// keys and values is staged in shared memory once per block and read by all
// its threads (the bank is re-read from L2 once per query tile, not per
// thread). Scores: warp w owns rows 4w..4w+3 and lane j owns slot j, so the
// row max and row sum of a tile are warp shuffles. Weighted sum: each thread
// owns 8 rows x 8 value columns (64 accumulators), 64 FMA per 4 shared
// loads. Two blocks fit on one SM (93 KB of shared memory each).
// ---------------------------------------------------------------------------
constexpr int R_THREADS = 128;
constexpr int R_TP = 16;             // query rows per block
constexpr int R_TN = 32;             // bank slots per tile
constexpr int R_PSTRIDE = 20;        // row stride of the probability tile
constexpr int R_SMEM_FLOATS =
    R_TP * KPAD + R_TN * KPAD + R_TN * DV + R_TN * R_PSTRIDE + R_TP;

__global__ void __launch_bounds__(R_THREADS)
read_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const uint8_t* __restrict__ valid,
            const int* __restrict__ occ_bound, float* __restrict__ mem,
            float* __restrict__ m_out, float* __restrict__ l_out, int P, int N,
            int chunk, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // [R_TP][KPAD]
  float* k_s = q_s + R_TP * KPAD;          // [R_TN][KPAD]
  float* v_s = k_s + R_TN * KPAD;          // [R_TN][DV]
  float* p_s = v_s + R_TN * DV;            // [R_TN][R_PSTRIDE]
  float* row_s = p_s + R_TN * R_PSTRIDE;   // [R_TP] rescale, then 1 / l

  const int obj = blockIdx.y;
  const int p0 = blockIdx.x * R_TP;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* kb = k + (size_t)obj * N * DK;
  const float* vb = v + (size_t)obj * N * DV;
  const uint8_t* okb = valid + (size_t)obj * N;
  const int n_visit = visited_slots(occ_bound, N, chunk);
  const int n_real = min(n_visit, N);

  load_rows<R_THREADS>(q_s, q, p0, R_TP, DK, KPAD, P);

  float m_run[4], l_run[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m_run[j] = NEG;
    l_run[j] = 0.f;
  }
  const int rg = tid >> 6;   // weighted-sum rows rg*8 .. rg*8+7
  const int cg = tid & 63;   // value columns cg*4 .. +3 and 256 + cg*4 .. +3
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int n0 = 0; n0 < n_visit; n0 += R_TN) {
    __syncthreads();   // the previous tile is consumed (and q_s is ready)
    load_rows<R_THREADS>(k_s, kb, n0, R_TN, DK, KPAD, n_real);
    load_rows<R_THREADS>(v_s, vb, n0, R_TN, DV, DV, n_real);
    __syncthreads();

    // Scores and the online-softmax update for rows 4w..4w+3, slot n0+lane.
    {
      const int n = n0 + lane;
      const float* kr = k_s + lane * KPAD;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < DK; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[j] = dot4(*reinterpret_cast<const float4*>(
                           q_s + (warp * 4 + j) * KPAD + d), kv, sc[j]);
      }
      const bool in_range = n < n_visit;
      const bool ok = in_range && n < N && okb[n] != 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // out-of-range slots weigh exactly 0; masked ones score NEG
        const float s = in_range ? (ok ? sc[j] * scale : NEG) : -INFINITY;
        const float m_new = fmaxf(m_run[j], warp_max(s));
        const float alpha = expf(m_run[j] - m_new);
        const float e = expf(s - m_new);
        l_run[j] = l_run[j] * alpha + warp_sum(e);
        m_run[j] = m_new;
        p_s[lane * R_PSTRIDE + warp * 4 + j] = e;
        if (lane == 0) row_s[warp * 4 + j] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + e . V for this thread's 8 rows x 8 columns.
    {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float a = row_s[rg * 8 + r];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] *= a;
      }
#pragma unroll 4
      for (int s = 0; s < R_TN; ++s) {
        const float4 pa = *reinterpret_cast<const float4*>(p_s + s * R_PSTRIDE + rg * 8);
        const float4 pb = *reinterpret_cast<const float4*>(p_s + s * R_PSTRIDE + rg * 8 + 4);
        const float4 va = *reinterpret_cast<const float4*>(v_s + s * DV + cg * 4);
        const float4 vc = *reinterpret_cast<const float4*>(v_s + s * DV + 256 + cg * 4);
        const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const float vr[8] = {va.x, va.y, va.z, va.w, vc.x, vc.y, vc.z, vc.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(pr[r], vr[c], acc[r][c]);
      }
    }
  }

  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = warp * 4 + j;
      const float l_safe = fmaxf(l_run[j], 1e-30f);
      row_s[row] = l_safe;
      if (p0 + row < P) {
        m_out[(size_t)obj * P + p0 + row] = m_run[j];
        l_out[(size_t)obj * P + p0 + row] = l_safe;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = p0 + rg * 8 + r;
    if (p >= P) continue;
    const float l_safe = row_s[rg * 8 + r];
    float* out = mem + ((size_t)obj * P + p) * DV;
    *reinterpret_cast<float4*>(out + cg * 4) = make_float4(
        acc[r][0] / l_safe, acc[r][1] / l_safe, acc[r][2] / l_safe, acc[r][3] / l_safe);
    *reinterpret_cast<float4*>(out + 256 + cg * 4) = make_float4(
        acc[r][4] / l_safe, acc[r][5] / l_safe, acc[r][6] / l_safe, acc[r][7] / l_safe);
  }
}

// ---------------------------------------------------------------------------
// Count kernel. Replaces _count_kernel, vfloodnet_tpu/ops/attention_pallas.py.
//
//   cnt[n] = #{p < P : q_p . k_n / sqrt(DK) > log_thres[p]}  for valid,
//            visited n; 0 elsewhere.
//
// What bounds it: operations (2 P N DK flop on N DK + P DK floats read).
//
// Design: the TPU kernel reduces over the query rows inside one grid step.
// Here the grid runs over tiles of 64 slots and each block loops over all P
// query rows, so each cnt[n] is written exactly once by one block: no
// atomics, and the result does not depend on the order blocks run in. The
// block's 64 keys stay in shared memory for the whole loop; tiles of 32 query
// rows stream through. Warp w scores rows 8w..8w+7 of each query tile, lane j
// slots j and j+32; the four warps' hit counts are summed in shared memory at
// the end. Blocks whose slots lie past the occupancy bound write zeros and
// return.
// ---------------------------------------------------------------------------
constexpr int C_THREADS = 128;
constexpr int C_TN = 64;    // bank slots per block
constexpr int C_TP = 32;    // query rows per tile
constexpr int C_SMEM_FLOATS = C_TN * KPAD + C_TP * KPAD + C_TP + 4 * C_TN;

__global__ void __launch_bounds__(C_THREADS)
count_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const uint8_t* __restrict__ valid,
             const int* __restrict__ occ_bound,
             const float* __restrict__ log_thres, float* __restrict__ cnt,
             int P, int N, int chunk, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                        // [C_TN][KPAD]
  float* q_s = k_s + C_TN * KPAD;           // [C_TP][KPAD]
  float* thr_s = q_s + C_TP * KPAD;         // [C_TP]
  int* hit_s = reinterpret_cast<int*>(thr_s + C_TP);   // [4][C_TN]

  const int obj = blockIdx.y;
  const int n0 = blockIdx.x * C_TN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_visit = visited_slots(occ_bound, N, chunk);
  float* cb = cnt + (size_t)obj * N;

  if (n0 >= n_visit) {   // uniform over the block
    for (int i = tid; i < C_TN; i += C_THREADS)
      if (n0 + i < N) cb[n0 + i] = 0.f;
    return;
  }

  load_rows<C_THREADS>(k_s, k + (size_t)obj * N * DK, n0, C_TN, DK, KPAD,
                       min(n_visit, N));
  const float* thr_b = log_thres + (size_t)obj * P;
  int hits0 = 0, hits1 = 0;
  for (int p0 = 0; p0 < P; p0 += C_TP) {
    __syncthreads();   // the previous query tile is consumed
    load_rows<C_THREADS>(q_s, q, p0, C_TP, DK, KPAD, P);
    for (int i = tid; i < C_TP; i += C_THREADS)
      thr_s[i] = (p0 + i < P) ? thr_b[p0 + i] : INFINITY;   // padded rows never hit
    __syncthreads();

    float s0[8], s1[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s0[r] = s1[r] = 0.f;
    const float* k0 = k_s + lane * KPAD;
    const float* k1 = k_s + (lane + 32) * KPAD;
#pragma unroll 2
    for (int d = 0; d < DK; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(k0 + d);
      const float4 b = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (warp * 8 + r) * KPAD + d);
        s0[r] = dot4(qv, a, s0[r]);
        s1[r] = dot4(qv, b, s1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float t = thr_s[warp * 8 + r];
      hits0 += (s0[r] * scale > t) ? 1 : 0;
      hits1 += (s1[r] * scale > t) ? 1 : 0;
    }
  }
  hit_s[warp * C_TN + lane] = hits0;
  hit_s[warp * C_TN + lane + 32] = hits1;
  __syncthreads();
  const uint8_t* okb = valid + (size_t)obj * N;
  for (int i = tid; i < C_TN; i += C_THREADS) {
    const int n = n0 + i;
    if (n >= N) continue;
    const int total = hit_s[i] + hit_s[C_TN + i] + hit_s[2 * C_TN + i] + hit_s[3 * C_TN + i];
    cb[n] = (n < n_visit && okb[n] != 0) ? (float)total : 0.f;
  }
}

}  // namespace

extern "C" {

int vft_bank_dims(int* dk, int* dv) {
  *dk = DK;
  *dv = DV;
  return 0;
}

int vft_bank_read(const float* q, const float* k, const float* v,
                  const uint8_t* valid, const int* occ_bound, float* mem,
                  float* m, float* l, int P, int N, int obj_n, int chunk,
                  float scale, void* stream) {
  const size_t smem = R_SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + R_TP - 1) / R_TP, obj_n);
  read_kernel<<<grid, R_THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, valid, occ_bound, mem, m, l, P, N, chunk, scale);
  return (int)cudaGetLastError();
}

int vft_bank_count(const float* q, const float* k, const uint8_t* valid,
                   const int* occ_bound, const float* log_thres, float* cnt,
                   int P, int N, int obj_n, int chunk, float scale,
                   void* stream) {
  const size_t smem = C_SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + C_TN - 1) / C_TN, obj_n);
  count_kernel<<<grid, C_THREADS, smem, (cudaStream_t)stream>>>(
      q, k, valid, occ_bound, log_thres, cnt, P, N, chunk, scale);
  return (int)cudaGetLastError();
}

const char* vft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
