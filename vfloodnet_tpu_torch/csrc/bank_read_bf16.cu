// Memory read and usage count over a bf16 feature bank, for Hopper (sm_90a).
//
// The bf16 forms of the read and count kernels of bank_read.cu, built with
// nvcc into a second shared library with a plain C interface and loaded
// with ctypes (vfloodnet_tpu_torch/ops/bank_read_cuda.py). Two kernels,
// launched on the caller's stream; they allocate nothing, and each launch
// function returns cudaGetLastError(). The read writes the same float32
// partials as the float32 read, so bank_read.cu's combine_kernel merges
// them.
//
// Shapes (row-major, contiguous):
//   q          [P, DK] bf16         query pixels, cast to the bank's type
//   k          [obj, N, DK] bf16    bank keys
//   v          [obj, N, DV] bf16    bank values
//   valid      [obj, N] uint8       slot validity
//   occ_bound  [1] int32 or NULL    occupancy bound, read on the device
//   m_part, l_part [obj, S, P], acc_part [obj, S, P, DV] float32 (read)
//   log_thres [obj, P] float32 -> cnt [obj, N] float32            (count)
//
// Arithmetic: the contract of the Pallas kernels on a bf16 bank
// (vfloodnet_tpu/ops/attention_pallas.py, mm_dtype = bf16): bf16 operands,
// float32 accumulation, on mma.sync.m16n8k16 .bf16 with float32 C and D.
// The scores q . k are float32 sums of exact bf16 products (the k-steps of
// DK in one fixed order, shared by the read and the count through
// warp_scores), the running max and normaliser are float32, the
// probabilities are rounded to bf16 for P V, and the count compares the
// float32 scores with a float32 log_thres. The plain versions are
// ops/attention.py's _read_occ_sweep / _count_occ_sweep on a bf16 bank.

#include <cuda_bf16.h>
#include <math.h>

#include "bank_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Row strides (bf16 elements) of q/k tiles and of value tiles in shared
// memory: 272 and 1040 bytes, both 16 mod 128, so the eight 16-byte rows of
// each ldmatrix 8x8 matrix fall on distinct bank groups.
constexpr int B_KS = DK + 8;
constexpr int B_VS = DV + 8;

// Starts the copy of rows [row0, row0 + ROWS) of a bf16 [*, WIDTH] matrix
// into shared memory with row stride STRIDE; rows at or beyond `limit` are
// zero-filled.
template <int THREADS, int ROWS, int WIDTH, int STRIDE>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src,
                                               int row0, int limit) {
  constexpr int W8 = WIDTH / 8;
  static_assert(ROWS * W8 % THREADS == 0, "whole rounds of 16-byte copies");
#pragma unroll
  for (int u = 0; u < ROWS * W8 / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / W8, c8 = i % W8;
    const bool ok = row0 + r < limit;
    const bf16* s = ok ? src + (size_t)(row0 + r) * WIDTH + c8 * 8 : src;
    cp_async16(dst + r * STRIDE + c8 * 8, s, ok);
  }
}

// Four 8x8 b16 matrices from shared memory; lanes 8i .. 8i + 7 give the row
// addresses of matrix i, and register i of lane l holds row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 of matrix i (of its transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// d += a . b on the tensor cores: a 16x16 (row), b 16x8 (col), bf16;
// d 16x8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Raw float32 scores q . k of one warp's 16 query rows against NT x 8 bank
// slots. q_w points at the warp's first query row, k_t at its first slot,
// both with row stride B_KS. Fragment layout of mma.m16n8k16 (g = lane / 4,
// t = lane % 4): s[j][0..1] are row g, slots 8j + 2t and 8j + 2t + 1;
// s[j][2..3] the same slots of row g + 8. Each score is one chain of DK / 16
// mma from zero, k-steps in ascending order, whatever NT is, so the read
// and the count compute the same float32 value for a (row, slot).
template <int NT>
__device__ __forceinline__ void warp_scores(const bf16* q_w, const bf16* k_t,
                                            float (&s)[NT][4]) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
  const int lane = threadIdx.x & 31;
  // A: lanes 0-15 rows 0-15 at k, lanes 16-31 the same rows at k + 8.
  const bf16* qa = q_w + (lane & 15) * B_KS + (lane >> 4) * 8;
  // B of n-tiles j, j + 1: lanes 0-7 slots 8j.. at k, 8-15 at k + 8, 16-23
  // slots 8j + 8.. at k, 24-31 at k + 8 (K [slot][k] is B's column-major).
  const bf16* kb = k_t + ((lane & 7) + ((lane >> 4) << 3)) * B_KS +
                   ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, qa + kk);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, kb + j * 8 * B_KS + kk);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Read kernel, bf16. Replaces _read_kernel of
// vfloodnet_tpu/ops/attention_pallas.py on a bf16 bank.
//
//   for one segment of the visited bank:
//   m_s[p] = max_n s_pn,  l_s[p] = sum_n e^(s_pn - m_s[p]),
//   acc_s[p] = sum_n bf16(e^(s_pn - m_s[p])) v_n,   s_pn = q_p . k_n / sqrt(DK)
//
// What bounds it: operations. Per object it does 2 P N (DK + DV) flop on
// 2 (P DK + N (DK + DV)) bytes, far above the card's balance point: the
// bound is the flop at the dense bf16 tensor rate (989 TFLOP/s).
//
// Design: the grid, the segments and the partials are those of the float32
// read (query tile of 64 rows x bank segment x object; combine_kernel
// merges the segments). 16 warps split the 64 x 512 accumulator: warp w owns
// query rows 16 (w % 4) .. +15 and value columns 128 (w / 4) .. +127 (64
// float32 accumulators a thread). As in FlashAttention-2, the scores stay in
// registers: each warp scores its 16 rows against the whole 32-slot tile,
// takes the row maxima with quad shuffles, and packs the probabilities of
// two adjacent 8-slot n-tiles to bf16 as the A fragment of a k = 16 P V
// step. The four warps of a row group each compute the same scores (Q K^T
// done four times, 1.6x the product work of the function), in exchange for
// no shared probability tile and no barrier inside the softmax. K [N, DK] is
// B's column-major layout already (ldmatrix), V [N, DV] is row-major and
// its B fragments come through ldmatrix.trans, so no transposed copy is
// made. K and V tiles stream through a two-stage cp.async ring (40 KB a
// stage). wgmma, TMA and warp specialisation are not used yet.
//
// A segment with no visited slot writes m = -inf, l = 0, acc = 0; one whose
// visited slots are all masked gets m = -1e30 (every visited slot, padding
// included, has weight 1), as the float32 read does.
// ---------------------------------------------------------------------------
constexpr int RB_THREADS = 512;
constexpr int RB_TN = 32;   // bank slots per tile: same as the float32 read
constexpr int RB_SMEM_BYTES =
    (QT * B_KS + 2 * RB_TN * B_KS + 2 * RB_TN * B_VS) * 2;

__global__ void __launch_bounds__(RB_THREADS, 1)
read_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const uint8_t* __restrict__ valid,
                 const int* __restrict__ occ_bound, float* __restrict__ m_part,
                 float* __restrict__ l_part, float* __restrict__ acc_part,
                 int P, int N, int chunk, int splits, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);    // [QT][B_KS]
  bf16* k_ring = q_s + QT * B_KS;                   // 2 x [RB_TN][B_KS]
  bf16* v_ring = k_ring + 2 * RB_TN * B_KS;         // 2 x [RB_TN][B_VS]

  const int p0 = blockIdx.x * QT;
  const int split = blockIdx.y, obj = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, cq = warp >> 2;   // row group, value quarter
  const int n_visit = visited_slots(occ_bound, N, chunk);
  const int seg = ((n_visit + splits - 1) / splits + RB_TN - 1) / RB_TN * RB_TN;
  const int lo = split * seg;
  const int hi = min(lo + seg, n_visit);
  const int n_real = min(hi, N);   // slots past it are zero padding
  const int row_a = rg * 16 + g;   // this thread's rows: row_a, row_a + 8
  const bf16* kb = k + (size_t)obj * N * DK;
  const bf16* vb = v + (size_t)obj * N * DV;
  const uint8_t* okb = valid + (size_t)obj * N;

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  if (lo < hi) {
    const int n_tiles = (hi - lo + RB_TN - 1) / RB_TN;
    load_rows_bf16<RB_THREADS, QT, DK, B_KS>(q_s, q, p0, P);
    load_rows_bf16<RB_THREADS, RB_TN, DK, B_KS>(k_ring, kb, lo, n_real);
    load_rows_bf16<RB_THREADS, RB_TN, DV, B_VS>(v_ring, vb, lo, n_real);
    cp_async_commit();
    // ldmatrix.trans row addresses of V: lanes 0-7 slots 0-7, 8-15 slots
    // 8-15 of a k-step, at columns +0 (lanes 0-15) or +8 (lanes 16-31).
    const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * B_VS + cq * 128 +
                      (lane >> 4) * 8;
    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = lo + it * RB_TN;
      const int st = it & 1;
      if (it + 1 < n_tiles) {   // the other stage was released by it - 1
        load_rows_bf16<RB_THREADS, RB_TN, DK, B_KS>(
            k_ring + (st ^ 1) * RB_TN * B_KS, kb, n0 + RB_TN, n_real);
        load_rows_bf16<RB_THREADS, RB_TN, DV, B_VS>(
            v_ring + (st ^ 1) * RB_TN * B_VS, vb, n0 + RB_TN, n_real);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      float s[RB_TN / 8][4];
      warp_scores<RB_TN / 8>(q_s + rg * 16 * B_KS, k_ring + st * RB_TN * B_KS,
                             s);
      // Scale and mask: out-of-segment slots weigh exactly 0, masked ones
      // score NEG. A tile always holds an in-segment slot, so m_new >= NEG
      // is finite and alpha is 0, not NaN, on the first tile.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < RB_TN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + 8 * j + 2 * t + c;
          const bool in_seg = n < hi;
          const bool ok = in_seg && n < N && okb[n] != 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = s[j][2 * r + c];
            x = in_seg ? (ok ? x * scale : NEG) : -INFINITY;
            mx[r] = fmaxf(mx[r], x);
          }
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        alpha[r] = expf(m_run[r] - m_new);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < RB_TN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[j][2 * r + c];
            x = expf(x - m_new);
            sum += x;
          }
        l_run[r] = l_run[r] * alpha[r] + sum;   // this thread's slots
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      // acc += P V over this warp's 128 value columns, 16 slots a k-step.
      const bf16* v_t = v_ring + st * RB_TN * B_VS + v_off;
#pragma unroll
      for (int ks = 0; ks < RB_TN / 16; ++ks) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * ks][0], s[2 * ks][1]),           // row g,     k 2t
            pack_bf16(s[2 * ks][2], s[2 * ks][3]),           // row g + 8, k 2t
            pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),   // row g,     k 2t + 8
            pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};  // row g + 8, k 2t + 8
#pragma unroll
        for (int jp = 0; jp < 8; ++jp) {
          uint32_t b[4];
          ldsm_x4_trans(b, v_t + ks * 16 * B_VS + jp * 16);
          mma_bf16(acc[2 * jp], a, b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();   // this stage is consumed before it is reloaded
    }
  }

  // Partials of rows pa = p0 + row_a and pb = pa + 8. The four warps of a
  // row group hold the same m and l; the first writes them.
  const float l_a = quad_sum(l_run[0]), l_b = quad_sum(l_run[1]);
  const int pa = p0 + row_a, pb = pa + 8;
  const size_t row0 = ((size_t)obj * splits + split) * P;
  if (cq == 0 && t == 0) {
    if (pa < P) {
      m_part[row0 + pa] = m_run[0];
      l_part[row0 + pa] = l_a;
    }
    if (pb < P) {
      m_part[row0 + pb] = m_run[1];
      l_part[row0 + pb] = l_b;
    }
  }
  float* out_a = acc_part + (row0 + pa) * DV + cq * 128 + 2 * t;
  float* out_b = acc_part + (row0 + pb) * DV + cq * 128 + 2 * t;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (pa < P)
      *reinterpret_cast<float2*>(out_a + j * 8) = make_float2(acc[j][0], acc[j][1]);
    if (pb < P)
      *reinterpret_cast<float2*>(out_b + j * 8) = make_float2(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// Count kernel, bf16. Replaces _count_kernel of
// vfloodnet_tpu/ops/attention_pallas.py on a bf16 bank.
//
//   cnt[n] = #{p < P : q_p . k_n / sqrt(DK) > log_thres[p]}  for valid,
//            visited n; 0 elsewhere.
//
// What bounds it: operations (2 P N DK flop at the bf16 tensor rate, on
// 2 (N DK + P DK) + 4 P bytes read and 4 N written).
//
// Design: that of the float32 count_kernel. The grid runs over tiles of 256
// slots; each block keeps its keys in shared memory and loops over all P
// query rows in 64-row tiles (a two-stage cp.async ring), so each cnt[n] is
// written once by one block: no atomics. Warp w of 16 scores query rows
// 16 (w % 4) .. +15 of each tile against slots 64 (w / 4) .. +63 with the
// read's warp_scores (the same float32 score for a (row, slot) as the read),
// keeps 16 hit counters in registers, and the counters are summed over the
// warp's rows with shuffles and over the four row groups in shared memory.
// Padded query rows compare against +inf and never hit. Blocks past the
// occupancy bound write zeros and return.
// ---------------------------------------------------------------------------
constexpr int CB_THREADS = 512;
constexpr int CB_TN = 256;   // bank slots per block
constexpr int CB_SMEM_BYTES =
    (CB_TN * B_KS + 2 * QT * B_KS) * 2 + 2 * QT * 4 + 4 * CB_TN * 4;

__global__ void __launch_bounds__(CB_THREADS, 1)
count_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const uint8_t* __restrict__ valid,
                  const int* __restrict__ occ_bound,
                  const float* __restrict__ log_thres,
                  float* __restrict__ cnt, int P, int N, int chunk,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);     // [CB_TN][B_KS]
  bf16* q_s = k_s + CB_TN * B_KS;                    // 2 x [QT][B_KS]
  float* thr_s = reinterpret_cast<float*>(q_s + 2 * QT * B_KS);   // 2 x [QT]
  int* hit_s = reinterpret_cast<int*>(thr_s + 2 * QT);            // [4][CB_TN]

  const int obj = blockIdx.y;
  const int n0 = blockIdx.x * CB_TN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, sq = warp >> 2;   // row group, slot quarter
  const int n_visit = visited_slots(occ_bound, N, chunk);
  float* cb = cnt + (size_t)obj * N;

  if (n0 >= n_visit) {   // uniform over the block
    for (int i = tid; i < CB_TN; i += CB_THREADS)
      if (n0 + i < N) cb[n0 + i] = 0.f;
    return;
  }

  const float* thr_b = log_thres + (size_t)obj * P;
  load_rows_bf16<CB_THREADS, CB_TN, DK, B_KS>(k_s, k + (size_t)obj * N * DK,
                                              n0, min(n_visit, N));
  load_rows_bf16<CB_THREADS, QT, DK, B_KS>(q_s, q, 0, P);
  cp_async_commit();
  for (int i = tid; i < QT; i += CB_THREADS)
    thr_s[i] = i < P ? thr_b[i] : INFINITY;   // padded rows never hit

  int hits[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) hits[j][0] = hits[j][1] = 0;
  const int n_pt = (P + QT - 1) / QT;
  for (int it = 0; it < n_pt; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_pt) {   // the other stage was released at the end of it - 1
      const int p1 = (it + 1) * QT;
      load_rows_bf16<CB_THREADS, QT, DK, B_KS>(q_s + (buf ^ 1) * QT * B_KS, q,
                                               p1, P);
      cp_async_commit();
      for (int i = tid; i < QT; i += CB_THREADS)
        thr_s[(buf ^ 1) * QT + i] = p1 + i < P ? thr_b[p1 + i] : INFINITY;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][4];
    warp_scores<8>(q_s + buf * QT * B_KS + rg * 16 * B_KS,
                   k_s + sq * 64 * B_KS, s);
    const float thr_a = thr_s[buf * QT + rg * 16 + g];
    const float thr_b8 = thr_s[buf * QT + rg * 16 + g + 8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hits[j][0] += (s[j][0] * scale > thr_a) + (s[j][2] * scale > thr_b8);
      hits[j][1] += (s[j][1] * scale > thr_a) + (s[j][3] * scale > thr_b8);
    }
    __syncthreads();   // this stage is consumed
  }

  // Sum over the warp's 16 rows (lanes of equal t), then over row groups.
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int h = hits[j][c];
      h += __shfl_xor_sync(0xffffffffu, h, 4);
      h += __shfl_xor_sync(0xffffffffu, h, 8);
      h += __shfl_xor_sync(0xffffffffu, h, 16);
      if (g == 0) hit_s[rg * CB_TN + sq * 64 + j * 8 + 2 * t + c] = h;
    }
  __syncthreads();
  const uint8_t* okb = valid + (size_t)obj * N;
  for (int i = tid; i < CB_TN; i += CB_THREADS) {
    const int n = n0 + i;
    if (n >= N) continue;
    const int total = hit_s[i] + hit_s[CB_TN + i] + hit_s[2 * CB_TN + i] +
                      hit_s[3 * CB_TN + i];
    cb[n] = (n < n_visit && okb[n] != 0) ? (float)total : 0.f;
  }
}

}  // namespace

extern "C" {

int vft_bf16_dims(int* dk, int* dv, int* read_tile, int* query_tile) {
  *dk = DK;
  *dv = DV;
  *read_tile = RB_TN;
  *query_tile = QT;
  return 0;
}

int vft_bank_read_bf16(const void* q, const void* k, const void* v,
                       const uint8_t* valid, const int* occ_bound,
                       float* m_part, float* l_part, float* acc_part, int P,
                       int N, int obj_n, int chunk, int splits, float scale,
                       void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      read_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      RB_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + QT - 1) / QT, splits, obj_n);
  read_bf16_kernel<<<grid, RB_THREADS, RB_SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), valid, occ_bound, m_part, l_part, acc_part,
      P, N, chunk, splits, scale);
  return (int)cudaGetLastError();
}

int vft_bank_count_bf16(const void* q, const void* k, const uint8_t* valid,
                        const int* occ_bound, const float* log_thres,
                        float* cnt, int P, int N, int obj_n, int chunk,
                        float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      count_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CB_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + CB_TN - 1) / CB_TN, obj_n);
  count_bf16_kernel<<<grid, CB_THREADS, CB_SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), valid,
      occ_bound, log_thres, cnt, P, N, chunk, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
