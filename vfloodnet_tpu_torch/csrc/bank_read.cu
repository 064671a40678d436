// Memory read and usage count over the feature bank, for Hopper (sm_90a).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (vfloodnet_tpu_torch/ops/bank_read_cuda.py). Three kernels, all
// launched on the caller's stream: the read (per bank segment), the combine
// of the segments, and the count. They allocate nothing, and each launch
// function returns cudaGetLastError().
//
// Shapes (row-major, contiguous):
//   q          [B, P, DK]         query pixels of the current frame of B
//                                 streams (B = 1: one plane for every object)
//   k          [obj, N, DK]       bank keys; obj = B x (objects a stream)
//   v          [obj, N, DV]       bank values
//   valid      [obj, N] uint8     slot validity
//   occ_bound  [1] int32 or NULL  occupancy bound, read on the device
//   m_part, l_part [obj, S, P], acc_part [obj, S, P, DV]   (read partials)
//   mem [obj, P, DV], m, l, log_thres [obj, P]              (combine)
//   log_thres [obj, P] -> cnt [obj, N] float32               (count)
//
// Occupancy bound (the semantics of vfloodnet_tpu/ops/attention.py
// _xla_read_occ): with c = min(chunk, N), only the first
// clip(ceil(occ/c), 1, ceil(N/c)) chunks of c slots are visited. Slots in a
// visited chunk at index >= N are zero padding and count as invalid; the
// valid mask still applies inside every visited chunk. The bound is read
// from device memory so that a step never waits on the host. Without a
// bound every one of the N slots is visited.
//
// Streams: the banks of B streams are folded along the object axis, and
// object o reads query plane o / obj_per_q (obj_per_q = obj / B), so one
// launch of each kernel serves every stream of a step (the JAX package
// vmaps the Pallas kernels over the streams, pipelines/video_seg_batch.py).
// The occupancy bound is one for every stream and object, as there.
//
// Arithmetic: 3xTF32 on the tensor cores (mma.sync.m16n8k8 .tf32), float32
// accumulation. Each operand x is split as hi = trunc(x), lo = trunc(x - hi),
// where trunc clears the low 13 mantissa bits (truncation toward zero, done
// with an integer mask so that the tensor cores get exact TF32 values), and
// a . b = lo_a hi_b + hi_a lo_b + hi_a hi_b; the chains of mma are kept
// short and summed with rounded float32 adds (warp_scores_part). Every
// product of
// the read (Q K^T and P V) and of the count (Q K^T) is done this way, and
// the count's scores come from the same device function (warp_scores_part)
// as the read's, in the same operation order, so the count compares the
// scores the read took its maximum over. tests/test_torch_bank_read_numerics.py
// emulates this rounding in numpy and holds it against the JAX package.

#include <math.h>

#include "bank_common.cuh"

namespace {

// Row stride (floats) of q and k tiles in shared memory: 8 mod 32, so that
// the 8-byte fragment loads of a half-warp hit 32 distinct banks.
constexpr int KS = DK + 8;
// Row stride of value tiles: 4 mod 16, so that the B-fragment loads of the
// P V product (rows 2t and 2t+1, columns g) hit 32 distinct banks.
constexpr int VS = DV + 4;

// Starts the copy of rows [row0, row0 + ROWS) of a [*, WIDTH] matrix into
// shared memory with row stride STRIDE; rows at or beyond `limit` are
// zero-filled.
template <int THREADS, int ROWS, int WIDTH, int STRIDE>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src,
                                                int row0, int limit) {
  constexpr int W4 = WIDTH / 4;
  static_assert(ROWS * W4 % THREADS == 0, "whole rounds of 16-byte copies");
#pragma unroll
  for (int u = 0; u < ROWS * W4 / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / W4, c4 = i % W4;
    const bool ok = row0 + r < limit;
    const float* s = ok ? src + (size_t)(row0 + r) * WIDTH + c4 * 4 : src;
    cp_async16(dst + r * STRIDE + c4 * 4, s, ok);
  }
}

// TF32 split: hi = trunc(x), lo = trunc(x - hi) (x - hi is exact in f32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b, a fresh accumulator (C = 0).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Raw scores q . k of one warp's 16 query rows against NT x 8 bank slots:
// adds the k-steps kk in [KK0, KK1) of DK to s. q_s points at the warp's
// first query row, k_s at its first slot, both with row stride KS. Fragment
// layout of mma.m16n8k8 (g = lane / 4, t = lane % 4): s[j][0..1] are row g,
// slots 8j + 2t and 8j + 2t + 1; s[j][2..3] the same slots of row g + 8.
// Within each k-step of 8 the k index t stands for element 2t and t + 4
// for element 2t + 1 (the same permutation on both operands leaves the
// dot product unchanged), so each fragment pair is one 8-byte load.
//
// The tensor cores add into their accumulator with truncation, so a long
// chain of mma on one accumulator drifts toward zero by up to an ulp a
// link (48 links over DK would exceed the tolerance of the scores). So
// each pair of k-steps chains its 6 mma from zero, and s takes the pair's
// sum with a rounded FADD.
template <int NT, int KK0, int KK1>
__device__ __forceinline__ void warp_scores_part(const float* q_s,
                                                 const float* k_s,
                                                 float (&s)[NT][4]) {
  static_assert(KK0 % 16 == 0 && KK1 % 16 == 0, "whole pairs of k-steps");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* qa = q_s + g * KS + 2 * t;
  const float* kb = k_s + g * KS + 2 * t;
#pragma unroll 2
  for (int kk = KK0; kk < KK1; kk += 16) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x = *reinterpret_cast<const float2*>(qa + kk + 8 * h);
      const float2 y = *reinterpret_cast<const float2*>(qa + 8 * KS + kk + 8 * h);
      split_tf32(x.x, ah[h][0], al[h][0]);   // row g,     k = t
      split_tf32(y.x, ah[h][1], al[h][1]);   // row g + 8, k = t
      split_tf32(x.y, ah[h][2], al[h][2]);   // row g,     k = t + 4
      split_tf32(y.y, ah[h][3], al[h][3]);   // row g + 8, k = t + 4
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float d[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 kv = *reinterpret_cast<const float2*>(
            kb + j * 8 * KS + kk + 8 * h);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kv.x, bh0, bl0);    // slot 8j + g, k = t
        split_tf32(kv.y, bh1, bl1);    // slot 8j + g, k = t + 4
        if (h == 0)
          mma_tf32_zero(d, al[0], bh0, bh1);
        else
          mma_tf32(d, al[1], bh0, bh1);
        mma_tf32(d, ah[h], bl0, bl1);
        mma_tf32(d, ah[h], bh0, bh1);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] += d[c];
    }
  }
}

template <int NT>
__device__ __forceinline__ void warp_scores(const float* q_s, const float* k_s,
                                            float (&s)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  warp_scores_part<NT, 0, DK>(q_s, k_s, s);
}

// ---------------------------------------------------------------------------
// Read kernel. Replaces _read_kernel, vfloodnet_tpu/ops/attention_pallas.py.
//
//   for one segment of the visited bank:
//   m_s[p] = max_n s_pn,  l_s[p] = sum_n e^(s_pn - m_s[p]),
//   acc_s[p] = sum_n e^(s_pn - m_s[p]) v_n,   s_pn = q_p . k_n / sqrt(DK)
//
// What bounds it: operations. Per object it does 2 P N (DK + DV) flop on
// P N DK + N (DK + DV) input floats, far above the card's balance point;
// in 3xTF32 each flop is three tensor-core flop, a bound of 3 x flop at
// 495 TFLOP/s (2.5x below the float32 CUDA-core bound). mma.sync reaches
// about two thirds of that rate on the H100; behind it come the bank's
// re-reads from L2 (once per query tile) and the ALU work of the TF32
// splits, which the tensor cores do not do.
//
// Design: the TPU kernel walks the bank on a sequential grid axis with its
// running max, normaliser and accumulator in VMEM. Here the grid is
// (query tile of 64 rows, bank segment, object): each block owns 64 query
// rows and one of S segments of the visited slots (ceil(n_visit / S),
// rounded up to the 32-slot tile), so that 2 x 26 query tiles x S fill the
// 132 SMs (flash-decoding style); the combine kernel merges the segments.
// The 64 x 512 accumulator does not fit one warpgroup's registers, so 16
// warps split it: warp w owns query rows 16 (w % 4) .. +15 and value
// columns 128 (w / 4) .. +127 (64 accumulators a thread, so that 16 warps
// fit an SM and hide each other's latencies). The four warps of a row group
// each score one 8-slot quarter of the 32-slot tile, exchange their row
// maxima through shared memory, and write their probabilities to a shared
// 64 x 32 tile, from which each reads the A fragments of its P V product:
// no score is computed twice, at the price of two barriers of 128 threads
// per tile. Keys (one tile ahead) and values stream through two-stage
// cp.async rings in shared memory, and the scores of tile i + 1 are
// interleaved with the P V products of tile i (two probability buffers),
// so the tensor cores have work while a softmax waits on its barriers.
//
// P V: the tensor cores take TF32 operands only from registers here
// (mma.sync), so V needs no transpose: wgmma would need it K-major (slot
// contiguous) in shared memory, which the [N, DV] bank is not and which TMA
// cannot transpose for 4-byte types. The B fragments are read straight
// from the dv-contiguous tile. With slot 2t standing for k = t and slot
// 2t + 1 for k = t + 4 (and the same order on V's rows), a pair of the
// probability tile's slots is one 8-byte load of the A fragment.
//
// A segment with no visited slot writes m = -inf, l = 0, acc = 0; one whose
// visited slots are all masked gets m = -1e30 (every visited slot, padding
// included, has weight 1), as the single sweep does.
// ---------------------------------------------------------------------------
constexpr int R_THREADS = 512;
constexpr int R_TN = 32;                        // bank slots per tile
constexpr int PS = R_TN + 8;                    // probability tile row stride
constexpr int R_SMEM_FLOATS =
    QT * KS + 2 * R_TN * KS + 2 * R_TN * VS + 2 * QT * PS + 4 * QT;

__device__ __forceinline__ void row_group_sync(int rg) {
  // the 4 warps (128 threads) of row group rg; barrier 0 is __syncthreads
  asm volatile("bar.sync %0, 128;\n" :: "r"(rg + 1) : "memory");
}

__global__ void __launch_bounds__(R_THREADS, 1)
read_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const uint8_t* __restrict__ valid,
            const int* __restrict__ occ_bound, float* __restrict__ m_part,
            float* __restrict__ l_part, float* __restrict__ acc_part, int P,
            int N, int obj_per_q, int chunk, int splits, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // [QT][KS]
  float* k_ring = q_s + QT * KS;           // 2 x [R_TN][KS]
  float* v_ring = k_ring + 2 * R_TN * KS;  // 2 x [R_TN][VS]
  float* p_ring = v_ring + 2 * R_TN * VS;  // 2 x [QT][PS] probabilities
  float* red_s = p_ring + 2 * QT * PS;     // [4][QT] row maxima, then sums

  const int p0 = blockIdx.x * QT;
  const int split = blockIdx.y, obj = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, qd = warp >> 2;   // row group, quarter
  const int n_visit = visited_slots(occ_bound, N, chunk);
  const int seg = ((n_visit + splits - 1) / splits + R_TN - 1) / R_TN * R_TN;
  const int lo = split * seg;
  const int hi = min(lo + seg, n_visit);
  const int n_real = min(hi, N);   // slots past it are zero padding
  const int row_a = rg * 16 + g;   // this thread's rows: row_a, row_a + 8
  const float* kb = k + (size_t)obj * N * DK;
  const float* vb = v + (size_t)obj * N * DV;
  const uint8_t* okb = valid + (size_t)obj * N;
  const float* qb = q + (size_t)(obj / obj_per_q) * P * DK;

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // Online softmax of a tile for rows row_a (r = 0) and row_a + 8 (r = 1),
  // from this warp's scores s of slots n0 + 8 qd + 2t + c (c = 0, 1) and
  // their slot_mask(n0) bits: the row maxima are exchanged with the row
  // group's other three warps, the probabilities go to p_buf, and alpha =
  // e^(m_old - m_new). Out-of-segment slots weigh exactly 0; masked ones
  // score NEG. A tile always holds an in-segment slot, so m_new >= NEG is
  // finite and alpha is 0, not NaN, on the first tile.
  auto slot_mask = [&](int n0) {   // bits c: in segment, 2 + c: valid
    const int n = n0 + qd * 8 + 2 * t;
    unsigned bits = 0;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (n + c < hi) {
        bits |= 1u << c;
        if (n + c < N && okb[n + c] != 0) bits |= 4u << c;
      }
    return bits;
  };
  auto softmax = [&](unsigned bits, float (&s)[1][4], float* p_buf,
                     float (&alpha)[2]) {
    float mx[2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[0][2 * r + c];
        x = (bits >> c & 1u) ? ((bits >> (2 + c) & 1u) ? x * scale : NEG)
                             : -INFINITY;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r] = quad_max(fmaxf(s[0][2 * r], s[0][2 * r + 1]));
    if (t == 0) {
      red_s[qd * QT + row_a] = mx[0];
      red_s[qd * QT + row_a + 8] = mx[1];
    }
    row_group_sync(rg);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      const float m_new = fmaxf(
          m_run[r], fmaxf(fmaxf(red_s[row], red_s[QT + row]),
                          fmaxf(red_s[2 * QT + row], red_s[3 * QT + row])));
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      const float e0 = expf(s[0][2 * r] - m_new);
      const float e1 = expf(s[0][2 * r + 1] - m_new);
      l_run[r] = l_run[r] * alpha[r] + (e0 + e1);   // this thread's slots
      *reinterpret_cast<float2*>(p_buf + row * PS + qd * 8 + 2 * t) =
          make_float2(e0, e1);
    }
    row_group_sync(rg);
  };

  // acc += P V for k-step ks (slots 8 ks .. 8 ks + 7) over this warp's 128
  // value columns. The 3 mma of each fragment start from zero and one
  // rounded add takes them into acc (a chain over the whole segment would
  // drift by its truncations, see warp_scores_part).
  auto pv_step = [&](int ks, const float* v_s, const float* p_buf) {
    const float* pa = p_buf + row_a * PS + 2 * t + ks * 8;
    const float2 x = *reinterpret_cast<const float2*>(pa);
    const float2 y = *reinterpret_cast<const float2*>(pa + 8 * PS);
    uint32_t ah[4], al[4];
    split_tf32(x.x, ah[0], al[0]);   // row g,     slot 2t     (k = t)
    split_tf32(y.x, ah[1], al[1]);   // row g + 8, slot 2t
    split_tf32(x.y, ah[2], al[2]);   // row g,     slot 2t + 1 (k = t + 4)
    split_tf32(y.y, ah[3], al[3]);   // row g + 8, slot 2t + 1
    const float* v0 = v_s + (ks * 8 + 2 * t) * VS + qd * 128 + g;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(v0[j * 8], bh0, bl0);
      split_tf32(v0[VS + j * 8], bh1, bl1);
      float d[4];
      mma_tf32_zero(d, al, bh0, bh1);
      mma_tf32(d, ah, bl0, bl1);
      mma_tf32(d, ah, bh0, bh1);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] += d[c];
    }
  };

  if (lo < hi) {
    // Software pipeline: iteration it multiplies P V of tile it while it
    // scores tile it + 1, so the tensor cores have the products of one
    // while the softmax of the other waits on its barriers. Keys run one
    // tile ahead of values: while iteration it computes, K[it + 2] and
    // V[it + 1] load into the stages that K[it] and V[it - 1] left.
    const int n_tiles = (hi - lo + R_TN - 1) / R_TN;
    load_rows_async<R_THREADS, QT, DK, KS>(q_s, qb, p0, P);
    load_rows_async<R_THREADS, R_TN, DK, KS>(k_ring, kb, lo, n_real);
    load_rows_async<R_THREADS, R_TN, DV, VS>(v_ring, vb, lo, n_real);
    if (n_tiles > 1)
      load_rows_async<R_THREADS, R_TN, DK, KS>(k_ring + R_TN * KS, kb,
                                               lo + R_TN, n_real);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float alpha[2];
    {
      const unsigned bits = slot_mask(lo);
      float s[1][4];
      warp_scores<1>(q_s + rg * 16 * KS, k_ring + qd * 8 * KS, s);
      softmax(bits, s, p_ring, alpha);
    }
    __syncthreads();   // K[0]'s stage is consumed before K[2] loads into it
    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = lo + it * R_TN;
      if (it + 1 < n_tiles) {
        if (it + 2 < n_tiles)
          load_rows_async<R_THREADS, R_TN, DK, KS>(
              k_ring + (it & 1) * R_TN * KS, kb, n0 + 2 * R_TN, n_real);
        load_rows_async<R_THREADS, R_TN, DV, VS>(
            v_ring + ((it + 1) & 1) * R_TN * VS, vb, n0 + R_TN, n_real);
        cp_async_commit();
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      // Scores of tile it + 1 (of a stale stage on the last tile, unused)
      // interleaved with P V of tile it, a quarter of DK per k-step.
      const float* k_next = k_ring + ((it + 1) & 1) * R_TN * KS + qd * 8 * KS;
      const float* q_w = q_s + rg * 16 * KS;
      const float* v_s = v_ring + (it & 1) * R_TN * VS;
      const float* p_buf = p_ring + (it & 1) * QT * PS;
      const unsigned bits = slot_mask(n0 + R_TN);
      float s[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      warp_scores_part<1, 0, 32>(q_w, k_next, s);
      pv_step(0, v_s, p_buf);
      warp_scores_part<1, 32, 64>(q_w, k_next, s);
      pv_step(1, v_s, p_buf);
      warp_scores_part<1, 64, 96>(q_w, k_next, s);
      pv_step(2, v_s, p_buf);
      warp_scores_part<1, 96, 128>(q_w, k_next, s);
      pv_step(3, v_s, p_buf);
      if (it + 1 < n_tiles)
        softmax(bits, s, p_ring + ((it + 1) & 1) * QT * PS, alpha);
      cp_async_wait<0>();
      __syncthreads();   // stages of tile it are consumed, it + 1's loaded
    }
  }

  // Partials of rows pa = p0 + row_a and pb = pa + 8: m is the same in the
  // four warps of a row group, l is summed over them.
  const float l_a = quad_sum(l_run[0]), l_b = quad_sum(l_run[1]);
  if (t == 0) {
    red_s[qd * QT + row_a] = l_a;
    red_s[qd * QT + row_a + 8] = l_b;
  }
  __syncthreads();
  const int pa = p0 + row_a, pb = pa + 8;
  const size_t row0 = ((size_t)obj * splits + split) * P;
  if (qd == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (p0 + row < P) {
        m_part[row0 + p0 + row] = m_run[r];
        l_part[row0 + p0 + row] = red_s[row] + red_s[QT + row] +
                                  red_s[2 * QT + row] + red_s[3 * QT + row];
      }
    }
  }
  float* out_a = acc_part + (row0 + pa) * DV + qd * 128 + 2 * t;
  float* out_b = acc_part + (row0 + pb) * DV + qd * 128 + 2 * t;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (pa < P)
      *reinterpret_cast<float2*>(out_a + j * 8) = make_float2(acc[j][0], acc[j][1]);
    if (pb < P)
      *reinterpret_cast<float2*>(out_b + j * 8) = make_float2(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// Combine kernel: merges the read's S segments (no TPU counterpart: the TPU
// kernel's single sequential sweep needs none).
//
//   M = max_s m_s,  w_s = e^(m_s - M) (0 for m_s = -inf),  l = sum_s w_s l_s,
//   mem = sum_s w_s acc_s / max(l, 1e-30),  log_thres = log(thres) + log l + M
//
// with l written clamped, as the single sweep writes it. What bounds it:
// bytes (S x 512 floats read per row). One block of 128 threads per (row,
// object), four value columns a thread.
// ---------------------------------------------------------------------------
constexpr int M_THREADS = DV / 4;

__global__ void __launch_bounds__(M_THREADS)
combine_kernel(const float* __restrict__ m_part,
               const float* __restrict__ l_part,
               const float* __restrict__ acc_part, float* __restrict__ mem,
               float* __restrict__ m_out, float* __restrict__ l_out,
               float* __restrict__ log_thres, int P, int splits,
               float log_thres0) {
  const int p = blockIdx.x, obj = blockIdx.y;
  const size_t row0 = (size_t)obj * splits * P + p;   // segment s: row0 + s P
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, m_part[row0 + (size_t)s * P]);
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const size_t row = row0 + (size_t)s * P;
    const float ms = m_part[row];
    const float w = ms == -INFINITY ? 0.f : expf(ms - M);
    l += w * l_part[row];
    const float4 a = reinterpret_cast<const float4*>(acc_part + row * DV)[threadIdx.x];
    o.x += w * a.x;
    o.y += w * a.y;
    o.z += w * a.z;
    o.w += w * a.w;
  }
  const float l_safe = fmaxf(l, 1e-30f);
  const size_t out = (size_t)obj * P + p;
  reinterpret_cast<float4*>(mem + out * DV)[threadIdx.x] =
      make_float4(o.x / l_safe, o.y / l_safe, o.z / l_safe, o.w / l_safe);
  if (threadIdx.x == 0) {
    m_out[out] = M;
    l_out[out] = l_safe;
    log_thres[out] = log_thres0 + logf(l_safe) + M;
  }
}

// ---------------------------------------------------------------------------
// Count kernel. Replaces _count_kernel, vfloodnet_tpu/ops/attention_pallas.py.
//
//   cnt[n] = #{p < P : q_p . k_n / sqrt(DK) > log_thres[p]}  for valid,
//            visited n; 0 elsewhere.
//
// What bounds it: operations (2 P N DK flop, 3x that on the tensor cores in
// 3xTF32, on N DK + P DK floats read); behind it, Q's re-reads from L2 (once
// per block) and the TF32 splits.
//
// Design: the TPU kernel reduces over the query rows inside one grid step.
// Here the grid runs over tiles of 256 slots and each block loops over all
// P query rows in 64-row tiles (a two-stage cp.async ring), so each cnt[n] is
// written exactly once by one block: no atomics, and the result does not
// depend on the order blocks run in. The block's 256 keys stay in shared
// memory for the whole loop (Q is re-read from L2 once per block). Warp w
// of 16 scores query rows 16 (w % 4) .. +15 of each tile against slots
// 64 (w / 4) .. +63 with the read's warp_scores, and keeps 16 hit counters
// (its fragment's columns) in registers; at the end they are summed over
// the warp's rows with shuffles and over the four row groups in shared
// memory. Padded query rows compare against +inf and never hit. Blocks
// whose slots lie past the occupancy bound write zeros and return (at one
// 8,192-slot chunk only 64 of the card's 132 SMs have slots to count; 128-
// slot blocks would fill it there, but re-read Q twice as often and were
// slower with a full bank, the steady state of a long video).
// ---------------------------------------------------------------------------
constexpr int C_THREADS = 512;
constexpr int C_TN = 256;   // bank slots per block
constexpr int C_SMEM_BYTES =
    (C_TN * KS + 2 * QT * KS + 2 * QT) * 4 + 4 * C_TN * 4;

__global__ void __launch_bounds__(C_THREADS, 1)
count_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const uint8_t* __restrict__ valid,
             const int* __restrict__ occ_bound,
             const float* __restrict__ log_thres, float* __restrict__ cnt,
             int P, int N, int obj_per_q, int chunk, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                        // [C_TN][KS]
  float* q_s = k_s + C_TN * KS;             // 2 x [QT][KS]
  float* thr_s = q_s + 2 * QT * KS;         // 2 x [QT]
  int* hit_s = reinterpret_cast<int*>(thr_s + 2 * QT);   // [4][C_TN]

  const int obj = blockIdx.y;
  const int n0 = blockIdx.x * C_TN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, sq = warp >> 2;   // row group, slot quarter
  const int n_visit = visited_slots(occ_bound, N, chunk);
  float* cb = cnt + (size_t)obj * N;

  if (n0 >= n_visit) {   // uniform over the block
    for (int i = tid; i < C_TN; i += C_THREADS)
      if (n0 + i < N) cb[n0 + i] = 0.f;
    return;
  }

  const float* thr_b = log_thres + (size_t)obj * P;
  const float* qb = q + (size_t)(obj / obj_per_q) * P * DK;
  load_rows_async<C_THREADS, C_TN, DK, KS>(k_s, k + (size_t)obj * N * DK, n0,
                                           min(n_visit, N));
  load_rows_async<C_THREADS, QT, DK, KS>(q_s, qb, 0, P);
  cp_async_commit();
  for (int i = tid; i < QT; i += C_THREADS)
    thr_s[i] = i < P ? thr_b[i] : INFINITY;   // padded rows never hit

  int hits[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) hits[j][0] = hits[j][1] = 0;
  const int n_pt = (P + QT - 1) / QT;
  for (int it = 0; it < n_pt; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_pt) {   // the other stage was released at the end of it - 1
      const int p1 = (it + 1) * QT;
      load_rows_async<C_THREADS, QT, DK, KS>(q_s + (buf ^ 1) * QT * KS, qb, p1,
                                              P);
      cp_async_commit();
      for (int i = tid; i < QT; i += C_THREADS)
        thr_s[(buf ^ 1) * QT + i] = p1 + i < P ? thr_b[p1 + i] : INFINITY;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][4];
    warp_scores<8>(q_s + buf * QT * KS + rg * 16 * KS, k_s + sq * 64 * KS,
                   s);
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
      if (g == 0) hit_s[rg * C_TN + sq * 64 + j * 8 + 2 * t + c] = h;
    }
  __syncthreads();
  const uint8_t* okb = valid + (size_t)obj * N;
  for (int i = tid; i < C_TN; i += C_THREADS) {
    const int n = n0 + i;
    if (n >= N) continue;
    const int total = hit_s[i] + hit_s[C_TN + i] + hit_s[2 * C_TN + i] +
                      hit_s[3 * C_TN + i];
    cb[n] = (n < n_visit && okb[n] != 0) ? (float)total : 0.f;
  }
}

}  // namespace

extern "C" {

int vft_bank_dims(int* dk, int* dv, int* read_tile, int* query_tile) {
  *dk = DK;
  *dv = DV;
  *read_tile = R_TN;
  *query_tile = QT;
  return 0;
}

int vft_bank_read(const float* q, const float* k, const float* v,
                  const uint8_t* valid, const int* occ_bound, float* m_part,
                  float* l_part, float* acc_part, int P, int N, int obj_n,
                  int q_planes, int chunk, int splits, float scale,
                  void* stream) {
  if (q_planes < 1 || obj_n % q_planes != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = R_SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + QT - 1) / QT, splits, obj_n);
  read_kernel<<<grid, R_THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, valid, occ_bound, m_part, l_part, acc_part, P, N,
      obj_n / q_planes, chunk, splits, scale);
  return (int)cudaGetLastError();
}

int vft_bank_combine(const float* m_part, const float* l_part,
                     const float* acc_part, float* mem, float* m, float* l,
                     float* log_thres, int P, int obj_n, int splits,
                     float log_thres0, void* stream) {
  const dim3 grid(P, obj_n);
  combine_kernel<<<grid, M_THREADS, 0, (cudaStream_t)stream>>>(
      m_part, l_part, acc_part, mem, m, l, log_thres, P, splits, log_thres0);
  return (int)cudaGetLastError();
}

int vft_bank_count(const float* q, const float* k, const uint8_t* valid,
                   const int* occ_bound, const float* log_thres, float* cnt,
                   int P, int N, int obj_n, int q_planes, int chunk,
                   float scale, void* stream) {
  if (q_planes < 1 || obj_n % q_planes != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = C_SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + C_TN - 1) / C_TN, obj_n);
  count_kernel<<<grid, C_THREADS, smem, (cudaStream_t)stream>>>(
      q, k, valid, occ_bound, log_thres, cnt, P, N, obj_n / q_planes, chunk,
      scale);
  return (int)cudaGetLastError();
}

const char* vft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
