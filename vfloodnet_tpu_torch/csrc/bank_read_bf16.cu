// Memory read and usage count over a bf16 feature bank, for Hopper (sm_90a).
//
// The bf16 forms of the read and count kernels of bank_read.cu, built with
// nvcc into a second shared library with a plain C interface and loaded
// with ctypes (vfloodnet_tpu_torch/ops/bank_read_cuda.py). Two kernels,
// launched on the caller's stream; they allocate nothing, and each launch
// function returns cudaGetLastError(). The read writes the same float32
// partials as the float32 read, so bank_read.cu's combine_kernel merges
// them. The count adds into a cnt that the caller has zeroed.
//
// Shapes (row-major, contiguous):
//   q          [B, P, DK] bf16      query pixels of B streams (B = 1: one
//                                   plane for every object), cast to the
//                                   bank's type
//   k          [obj, N, DK] bf16    bank keys; obj = B x (objects a stream)
//   v          [obj, N, DV] bf16    bank values
//   valid      [obj, N] uint8       slot validity
//   occ_bound  [1] int32 or NULL    occupancy bound, read on the device
//   m_part, l_part [obj, S, P], acc_part [obj, S, P, DV] float32 (read)
//   log_thres [obj, P] float32 -> cnt [obj, N] float32            (count)
//
// Streams: as in bank_read.cu, object o reads query plane o / obj_per_q;
// the Q tensor map has B planes and its TMA copies take the plane as their
// outer coordinate.
//
// Arithmetic: the contract of the Pallas kernels on a bf16 bank
// (vfloodnet_tpu/ops/attention_pallas.py, mm_dtype = bf16): bf16 operands,
// float32 accumulation, on wgmma (m64nNk16 .bf16, float32 D). The scores
// q . k are float32 sums of exact bf16 products (the eight k-steps of DK
// from zero in ascending order, shared by the read and the count through
// wg_scores), the running max and normaliser are float32, the
// probabilities are rounded to bf16 for P V, and the count compares the
// float32 scores with a float32 log_thres. The plain versions are
// ops/attention.py's _read_occ_sweep / _count_occ_sweep on a bf16 bank.
//
// Hopper machinery common to both kernels: tiles are copied by the Tensor
// Memory Accelerator (TMA) into shared memory with the 128-byte swizzle,
// through tensor maps made on the host per launch (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda)
// and passed as __grid_constant__ parameters. Every map is 3-D, [outer,
// rows, cols] with a box of [1, rows, 64]: 64 bf16 are one 128-byte swizzle
// row, so a DK = 128 row is two boxes and a DV = 512 row eight, and rows
// past an object's N read as zeros (the zero padding of the visited
// chunks) instead of the next object's rows. Copies complete on mbarriers;
// one producer warpgroup (one thread of it issues the copies, on 40
// registers) feeds two consumer warpgroups (232 registers) through rings of
// stages with full and empty barriers, and no block barrier is taken after
// the set-up.

#include <cuda.h>   // CUtensorMap and the driver API's types; no -lcuda
#include <cuda_bf16.h>
#include <math.h>

#include "bank_common.cuh"

namespace {

constexpr int BOX_W = 64;              // bf16 columns in one swizzle row
constexpr int ROW_BYTES = BOX_W * 2;   // 128
constexpr int THREADS = 384;           // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed (the k-th
// completion of a barrier has parity k & 1).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at (col, row, outer) of a 3-D tensor map into shared memory
// at dst (1024-byte aligned), completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int outer) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(outer)
      : "memory");
}

// Named barrier over the `count` threads of one warpgroup.
__device__ __forceinline__ void wg_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle, as its two 32-bit
// halves (joined inside the wgmma's asm): lo = start address and leading
// byte offset, hi = stride byte offset and the swizzle mode, the same for
// every descriptor here (offsets in 16-byte units). K-major tiles
// ([rows][64] boxes): rows in groups of 8 at a stride of 1024 bytes, the
// k-step of 16 elements a 32-byte advance of the start inside the swizzle
// row, the leading offset unused. MN-major tiles (V as [k][n]): k rows in
// groups of 8 at 1024 bytes, the next 64 columns (the next box) at the
// leading offset.
struct Desc {
  uint32_t lo, hi;
};

__device__ __forceinline__ Desc sw128_desc(uint32_t saddr, uint32_t lbo) {
  return {((saddr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16),
          (1024 >> 4) | (1u << 30)};
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until every committed group of wgmma has finished.
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders the compiler's reads and writes of accumulator registers against
// the asynchronous wgmma that own them (after a wait, before an issue).
template <int K>
__device__ __forceinline__ void reg_fence(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// The same for the register A operand of wgmma, whose registers must hold
// their values until the wgmma has completed.
template <int K, int L>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[K][L]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < L; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d += a . b^T, m64n64k16: a [64 x 16] and b [64 x 16], both K-major in
// shared memory behind descriptors (each passed as its two 32-bit halves).
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], Desc a,
                                                Desc b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%32, %33};\nmov.b64 db, {%34, %35};\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a.lo), "r"(a.hi), "r"(b.lo), "r"(b.hi), "r"(1));
}

// d = a . b^T, m64n64k16: the first k-step of a product, with d a pure
// output (a "+f" operand would make the compiler hold 32 input values for
// it through the loop).
__device__ __forceinline__ void wgmma_m64n64_ss_first(float (&d)[32], Desc a,
                                                      Desc b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%32, %33};\nmov.b64 db, {%34, %35};\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a.lo), "r"(a.hi), "r"(b.lo), "r"(b.hi), "r"(0));
}

// d += a . b, m64n256k16: a [64 x 16] bf16 in registers (per warp, the
// m16n8k16 A fragment of its 16 rows), b [16 x 256] MN-major (row-major
// [k][n]) in shared memory behind a descriptor.
__device__ __forceinline__ void wgmma_m64n256_rs(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 Desc b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%132, %133};\nsetp.ne.b32 p, %134, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.lo), "r"(b.hi),
        "r"(1));
}

// Raw float32 scores q . k of a warpgroup's 64 query rows against 64 bank
// slots, as eight m64n64k16 wgmma from zero, k-steps in ascending order;
// issued only (the caller fences before and commits and waits after). q_s:
// the query tile's two [64][64] boxes (k 0-63, then 64-127, 8 KB apart);
// k_s: the slots' first box, the second `k_box` bytes on. The read and the
// count both take their scores from here, so a (row, slot) gets the same
// float32 score in both. Accumulator layout (g = lane / 4, t = lane % 4,
// w = warp of the warpgroup): s[4j + 2r + c] is row 16w + g + 8r, slot
// 8j + 2t + c.
__device__ __forceinline__ void wg_scores(uint32_t q_s, uint32_t k_s,
                                          uint32_t k_box, float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;   // bytes into the swizzle row
    const Desc a = sw128_desc(q_s + (kk >> 2) * QT * ROW_BYTES + col, 16);
    const Desc b = sw128_desc(k_s + (kk >> 2) * k_box + col, 16);
    if (kk == 0)
      wgmma_m64n64_ss_first(s, a, b);
    else
      wgmma_m64n64_ss(s, a, b);
  }
}

// Two floats as a bf16 pair (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
// Design (the shape of FlashAttention-3): the grid, the segments and the
// partials are those of the float32 read (query tile of 64 rows x bank
// segment x object; combine_kernel merges the segments). Per block, one
// producer warpgroup and two consumer warpgroups. The producer's one
// thread copies the query tile once and then, for each 64-slot tile of the
// segment, the K tile [64, 128] (2 boxes) and the V tile [64, 512] (8
// boxes) into a two-stage ring (80 KB a stage). Each consumer warpgroup
// owns the block's 64 query rows and half of DV: 256 value columns, 128
// float32 accumulators a thread. Each computes its own S = Q K^T (wg_scores:
// Q K^T done twice per block, 1.2x the function's product work; a shared P
// tile would cost a barrier between the warpgroups), masks and scales S,
// runs the online softmax in registers (row maxima over the quad, e^x as
// exp2f), packs the probabilities to bf16 straight from the S fragment as
// the register A operand of P V (m64n256k16, four k-steps a tile), and
// takes V [64, 512] row-major as the MN-major B operand, so no transposed
// copy is made. Each consumer warp releases a stage when its wgmma have
// completed. The two warpgroups run unsynchronised, so one's softmax
// overlaps the other's wgmma. (Issuing the next tile's Q K^T before this
// tile's P V, as FlashAttention-3 does within a warpgroup, made ptxas
// serialise the wgmma, C7514, and was slower.)
//
// A segment with no visited slot writes m = -inf, l = 0, acc = 0; one whose
// visited slots are all masked gets m = -1e30 (every visited slot, padding
// included, has weight 1), as the float32 read does.
// ---------------------------------------------------------------------------
constexpr int RB_T = 64;   // bank slots per tile: S's n, P V's k
constexpr float LOG2E = 1.4426950408889634f;
constexpr int RB_STAGES = 2;
constexpr int RB_Q_BYTES = 2 * QT * ROW_BYTES;               // 16 KB
constexpr int RB_K_BYTES = 2 * RB_T * ROW_BYTES;             // 16 KB
constexpr int RB_V_BOX = RB_T * ROW_BYTES;                   // 8 KB
constexpr int RB_STAGE_BYTES = RB_K_BYTES + (DV / BOX_W) * RB_V_BOX;
constexpr int RB_SMEM_BYTES =
    1024 + RB_Q_BYTES + RB_STAGES * RB_STAGE_BYTES + 64;   // + alignment

__global__ void __launch_bounds__(THREADS, 1)
read_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const uint8_t* __restrict__ valid,
                 const int* __restrict__ occ_bound, float* __restrict__ m_part,
                 float* __restrict__ l_part, float* __restrict__ acc_part,
                 int P, int N, int obj_per_q, int chunk, int splits,
                 float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;                      // 2 boxes [QT][64]
  unsigned char* ring = q_s + RB_Q_BYTES;         // stages: K boxes, V boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + RB_STAGES *
                                               RB_STAGE_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                      // [RB_STAGES]
  uint64_t* empty = bars + 1 + RB_STAGES;         // [RB_STAGES]

  const int p0 = blockIdx.x * QT;
  const int split = blockIdx.y, obj = blockIdx.z;
  const int wg = threadIdx.x >> 7;
  const int n_visit = visited_slots(occ_bound, N, chunk);
  const int seg = ((n_visit + splits - 1) / splits + RB_T - 1) / RB_T * RB_T;
  const int lo = split * seg;
  const int hi = min(lo + seg, n_visit);
  const int n_tiles = lo < hi ? (hi - lo + RB_T - 1) / RB_T : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < RB_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {   // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, RB_Q_BYTES);
      tma_load(q_s, &q_map, q_full, 0, p0, obj / obj_per_q);
      tma_load(q_s + QT * ROW_BYTES, &q_map, q_full, BOX_W, p0,
               obj / obj_per_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % RB_STAGES, n0 = lo + it * RB_T;
        if (it >= RB_STAGES) mbar_wait(&empty[st], (it / RB_STAGES - 1) & 1);
        unsigned char* k_t = ring + st * RB_STAGE_BYTES;
        unsigned char* v_t = k_t + RB_K_BYTES;
        mbar_expect_tx(&full[st], RB_STAGE_BYTES);
        tma_load(k_t, &k_map, &full[st], 0, n0, obj);
        tma_load(k_t + RB_T * ROW_BYTES, &k_map, &full[st], BOX_W, n0, obj);
#pragma unroll
        for (int b = 0; b < DV / BOX_W; ++b)
          tma_load(v_t + b * RB_V_BOX, &v_map, &full[st], b * BOX_W, n0, obj);
      }
    }
  } else {   // consumers: warpgroup h owns value columns 256 h .. + 255
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int h = wg - 1;
    const int tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const uint8_t* okb = valid + (size_t)obj * N;

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % RB_STAGES, n0 = lo + it * RB_T;
      // Validity of the tile's 64 slots as bits; out-of-segment slots and
      // the padding past N are 0.
      const int na = n0 + lane, nb = na + 32;
      const bool ok_a = na < hi && na < N && okb[na] != 0;
      const bool ok_b = nb < hi && nb < N && okb[nb] != 0;
      const uint64_t ok_bits =
          (uint64_t)__ballot_sync(0xffffffffu, ok_a) |
          ((uint64_t)__ballot_sync(0xffffffffu, ok_b) << 32);
      // This thread's columns are 8 j + 2 t + c: shift by 2 t once, so that
      // each column's bit and bound are compile-time offsets.
      const uint64_t ok_t = ok_bits >> (2 * t);
      const int lim_t = hi - n0 - 2 * t;   // in-segment: 8 j + c < lim_t
      const uint32_t k_t = smem_u32(ring + st * RB_STAGE_BYTES);
      const uint32_t v_t = k_t + RB_K_BYTES + h * 4 * RB_V_BOX;
      mbar_wait(&full[st], (it / RB_STAGES) & 1);

      float s[32];
      wg_fence();
      wg_scores(smem_u32(q_s), k_t, RB_T * ROW_BYTES, s);
      wg_commit();
      wg_wait_all();
      reg_fence(s);

      // Scale and mask: out-of-segment slots weigh exactly 0, masked ones
      // score NEG. A tile always holds an in-segment slot, so m_new >= NEG
      // is finite and alpha is 0, not NaN, on the first tile.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < RB_T / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = (ok_t >> (8 * j + c)) & 1;
          const float out = 8 * j + c < lim_t ? NEG : -INFINITY;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = s[4 * j + 2 * r + c];
            x = ok ? x * scale : out;
            mx[r] = fmaxf(mx[r], x);
          }
        }
      // e^(x - m) as 2^((x - m) log2 e): three instructions where expf
      // takes about eight, relative error ~1e-6 on the weights that count
      // (far inside the read's bars); x - m is exactly 0 at the max, so an
      // all-masked tile (x = m = NEG) still weighs 1
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        alpha[r] = exp2f((m_run[r] - m_new) * LOG2E);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < RB_T / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[4 * j + 2 * r + c];
            x = exp2f((x - m_new) * LOG2E);
            sum += x;
          }
        l_run[r] = l_run[r] * alpha[r] + sum;   // this thread's slots
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      // P as the A fragments of the four k-steps: slots 16 kk .. + 15 are
      // the 8-slot blocks 2 kk and 2 kk + 1 of S.
      uint32_t a[RB_T / 16][4];
#pragma unroll
      for (int kk = 0; kk < RB_T / 16; ++kk) {
        a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);       // row g, k 2t
        a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);   // row g + 8
        a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);   // row g, k 2t + 8
        a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);   // row g + 8
      }
      reg_fence(acc);
      reg_fence(a);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < RB_T / 16; ++kk)
        wgmma_m64n256_rs(acc, a[kk],
                         sw128_desc(v_t + kk * 16 * ROW_BYTES, RB_V_BOX));
      wg_commit();
      wg_wait_all();
      reg_fence(acc);
      reg_fence(a);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // Partials of rows pa = p0 + 16 w + g and pb = pa + 8. Both warpgroups
    // hold the same m and l; the first writes them.
    const float l_a = quad_sum(l_run[0]), l_b = quad_sum(l_run[1]);
    const int pa = p0 + 16 * w + g, pb = pa + 8;
    const size_t row0 = ((size_t)obj * splits + split) * P;
    if (h == 0 && t == 0) {
      if (pa < P) {
        m_part[row0 + pa] = m_run[0];
        l_part[row0 + pa] = l_a;
      }
      if (pb < P) {
        m_part[row0 + pb] = m_run[1];
        l_part[row0 + pb] = l_b;
      }
    }
    float* out_a = acc_part + (row0 + pa) * DV + h * 256 + 2 * t;
    float* out_b = acc_part + (row0 + pb) * DV + h * 256 + 2 * t;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (pa < P)
        *reinterpret_cast<float2*>(out_a + 8 * j) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (pb < P)
        *reinterpret_cast<float2*>(out_b + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
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
// Design: the work is cut into items of (object, tile of CB_TN = 512
// visited slots, share of the query tiles). How many shares a slot tile
// takes (count_splits) is chosen on the device from the visited slots, so
// that a bank of one 8,192-slot chunk still gives every SM work; the
// grid is one block per SM, and each block walks over items. A block keeps
// its item's keys resident in shared memory (128 KB, loaded once per item)
// and streams the item's 64-row query tiles through a four-stage ring;
// consumer warpgroup h scores each query tile against slots 256 h .. + 255
// of the item as four wg_scores (the read's score function, so a (row,
// slot) has the read's float32 score), compares in registers and keeps
// packed 16-bit hit counters (an item holds at most 1,023 query tiles, so
// they cannot overflow). At the end of an item the counters are summed
// over the eight row lanes with shuffles and over the four warps in shared
// memory, and added to cnt with atomicAdd: integer-valued float32 sums
// below 2^24 are exact in any order. Padded query rows compare against
// +inf and never hit; invalid slots and slots past the bound get nothing,
// so the zeroed cnt keeps 0 there. There is no block barrier inside the
// query loop.
// ---------------------------------------------------------------------------
constexpr int CB_TN = 512;     // bank slots per item
constexpr int CB_QSTAGES = 4;
constexpr int CB_MAX_QTILES = 1023;   // query tiles per item: 16-bit counters
constexpr int CB_K_BYTES = 2 * CB_TN * ROW_BYTES;            // 128 KB
constexpr int CB_Q_BYTES = 2 * QT * ROW_BYTES;               // 16 KB
constexpr int CB_HIT_BYTES = 2 * 4 * 256 * 4;                // 8 KB
constexpr int CB_SMEM_BYTES =
    1024 + CB_K_BYTES + CB_QSTAGES * CB_Q_BYTES + CB_HIT_BYTES + 128;

// Query-tile shares of each slot tile: 1 when the slot tiles alone fill
// the `sms` blocks; else the share count s in [ceil(sms / slot_tiles),
// 2 ceil(sms / slot_tiles)] (at most q_tiles) whose slot_tiles x s items
// leave the least of the last round of blocks idle (the smallest such s),
// and never fewer than ceil(q_tiles / CB_MAX_QTILES).
// ops/bank_read_cuda.py::count_splits is the same rule in Python.
__device__ __forceinline__ int count_splits(int slot_tiles, int q_tiles,
                                            int sms) {
  const int least = (q_tiles + CB_MAX_QTILES - 1) / CB_MAX_QTILES;
  if (slot_tiles >= sms) return least;
  const int lo = max(min((sms + slot_tiles - 1) / slot_tiles, q_tiles), least);
  const int hi = max(min(2 * lo, q_tiles), lo);
  int best = lo;
  long long best_items = (long long)slot_tiles * lo;
  long long best_cap = (best_items + sms - 1) / sms * sms;
  for (int s = lo + 1; s <= hi; ++s) {
    const long long items = (long long)slot_tiles * s;
    const long long cap = (items + sms - 1) / sms * sms;
    if (items * best_cap > best_items * cap) {   // a fuller last round
      best = s;
      best_items = items;
      best_cap = cap;
    }
  }
  return best;
}

__global__ void __launch_bounds__(THREADS, 1)
count_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const uint8_t* __restrict__ valid,
                  const int* __restrict__ occ_bound,
                  const float* __restrict__ log_thres,
                  float* __restrict__ cnt, int P, int N, int obj_n,
                  int obj_per_q, int chunk, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_s = smem;   // [2 column halves][CB_TN][64]
  unsigned char* q_ring = k_s + CB_K_BYTES;   // stages of 2 boxes [QT][64]
  int* hit_s = reinterpret_cast<int*>(q_ring + CB_QSTAGES * CB_Q_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(hit_s) + CB_HIT_BYTES);
  uint64_t* k_full = bars;
  uint64_t* k_empty = bars + 1;
  uint64_t* q_full = bars + 2;                 // [CB_QSTAGES]
  uint64_t* q_empty = bars + 2 + CB_QSTAGES;   // [CB_QSTAGES]

  const int wg = threadIdx.x >> 7;
  const int n_cnt = min(visited_slots(occ_bound, N, chunk), N);
  const int tiles_per_obj = (n_cnt + CB_TN - 1) / CB_TN;
  const int q_tiles = (P + QT - 1) / QT;
  const int splits = count_splits(obj_n * tiles_per_obj, q_tiles, gridDim.x);
  const int n_items = obj_n * tiles_per_obj * splits;

  if (threadIdx.x == 0) {
    mbar_init(k_full, 1);
    mbar_init(k_empty, 8);   // lane 0 of each consumer warp
    for (int i = 0; i < CB_QSTAGES; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {   // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int qi = 0, ii = 0;   // query tiles and items of this block so far
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++ii) {
        const int obj = item / (tiles_per_obj * splits);
        const int rest = item % (tiles_per_obj * splits);
        const int n0 = rest / splits * CB_TN, share = rest % splits;
        const int qa = share * q_tiles / splits;
        const int qb = (share + 1) * q_tiles / splits;
        if (ii > 0) mbar_wait(k_empty, (ii - 1) & 1);
        mbar_expect_tx(k_full, CB_K_BYTES);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int r = 0; r < CB_TN / 256; ++r)
            tma_load(k_s + c * CB_TN * ROW_BYTES + r * 256 * ROW_BYTES,
                     &k_map, k_full, c * BOX_W, n0 + 256 * r, obj);
        for (int qt = qa; qt < qb; ++qt, ++qi) {
          const int st = qi % CB_QSTAGES;
          if (qi >= CB_QSTAGES)
            mbar_wait(&q_empty[st], (qi / CB_QSTAGES - 1) & 1);
          unsigned char* q_t = q_ring + st * CB_Q_BYTES;
          mbar_expect_tx(&q_full[st], CB_Q_BYTES);
          tma_load(q_t, &q_map, &q_full[st], 0, qt * QT, obj / obj_per_q);
          tma_load(q_t + QT * ROW_BYTES, &q_map, &q_full[st], BOX_W,
                   qt * QT, obj / obj_per_q);
        }
      }
    }
  } else {   // consumers: warpgroup h scores slots 256 h .. + 255 of an item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int h = wg - 1;
    const int tid = threadIdx.x & 127;
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    int* hits_w = hit_s + (h * 4 + w) * 256;   // this warp's column sums
    int qi = 0, ii = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++ii) {
      const int obj = item / (tiles_per_obj * splits);
      const int rest = item % (tiles_per_obj * splits);
      const int n0 = rest / splits * CB_TN, share = rest % splits;
      const int qa = share * q_tiles / splits;
      const int qb = (share + 1) * q_tiles / splits;
      const float* thr_o = log_thres + (size_t)obj * P;
      // hits[8 b + j]: low half slot 64 b + 8 j + 2 t, high half the next
      uint32_t hits[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) hits[i] = 0;
      const uint32_t k_h = smem_u32(k_s) + h * 256 * ROW_BYTES;
      mbar_wait(k_full, ii & 1);
      for (int qt = qa; qt < qb; ++qt, ++qi) {
        const int st = qi % CB_QSTAGES;
        const int pa = qt * QT + 16 * w + g, pb = pa + 8;
        const float thr_a = pa < P ? thr_o[pa] : INFINITY;
        const float thr_b = pb < P ? thr_o[pb] : INFINITY;
        mbar_wait(&q_full[st], (qi / CB_QSTAGES) & 1);
        float s[4][32];
        wg_fence();
#pragma unroll
        for (int b = 0; b < 4; ++b)
          wg_scores(smem_u32(q_ring + st * CB_Q_BYTES),
                    k_h + b * 64 * ROW_BYTES, CB_TN * ROW_BYTES, s[b]);
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int b = 0; b < 4; ++b) reg_fence(s[b]);
        if (lane == 0) mbar_arrive(&q_empty[st]);
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t h0 = (s[b][4 * j] * scale > thr_a) +
                                (s[b][4 * j + 2] * scale > thr_b);
            const uint32_t h1 = (s[b][4 * j + 1] * scale > thr_a) +
                                (s[b][4 * j + 3] * scale > thr_b);
            hits[8 * b + j] += h0 | (h1 << 16);
          }
      }
      if (lane == 0) mbar_arrive(k_empty);

      // Sum over the warp's 16 rows (lanes of equal t), then over the
      // warpgroup's four warps, and add the valid visited slots to cnt.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        uint32_t v = hits[i];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) {
          const int col = 64 * (i >> 3) + 8 * (i & 7) + 2 * t;
          hits_w[col] = (int)(v & 0xffffu);
          hits_w[col + 1] = (int)(v >> 16);
        }
      }
      wg_bar(1 + h, 128);
      const int* hits_h = hit_s + h * 4 * 256;
      const uint8_t* okb = valid + (size_t)obj * N;
      float* cb = cnt + (size_t)obj * N;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = tid + 128 * u;
        const int n = n0 + 256 * h + col;
        const int total = hits_h[col] + hits_h[256 + col] +
                          hits_h[512 + col] + hits_h[768 + col];
        if (n < n_cnt && okb[n] != 0 && total != 0)
          atomicAdd(cb + n, (float)total);
      }
      wg_bar(1 + h, 128);   // the sums are read before the next item's
    }
  }
}

}  // namespace

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the driver the runtime has loaded, looked up
// once; null if the driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a contiguous bf16 [outer, rows, cols] array with boxes
// of [1, box_rows, 64] and the 128-byte swizzle; rows past `rows` (and
// columns past `cols`) read as zeros. Returns a cudaError_t.
int make_map(CUtensorMap* map, const void* base, int cols, int rows,
             int outer, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * rows * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BOX_W, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int vft_bf16_dims(int* dk, int* dv, int* read_tile, int* query_tile) {
  *dk = DK;
  *dv = DV;
  *read_tile = RB_T;
  *query_tile = QT;
  return 0;
}

int vft_bank_read_bf16(const void* q, const void* k, const void* v,
                       const uint8_t* valid, const int* occ_bound,
                       float* m_part, float* l_part, float* acc_part, int P,
                       int N, int obj_n, int q_planes, int chunk, int splits,
                       float scale, void* stream) {
  if (q_planes < 1 || obj_n % q_planes != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, DK, P, q_planes, QT);
  if (err == 0) err = make_map(&k_map, k, DK, N, obj_n, RB_T);
  if (err == 0) err = make_map(&v_map, v, DV, N, obj_n, RB_T);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(read_bf16_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  RB_SMEM_BYTES);
  if (err != 0) return err;
  const dim3 grid((P + QT - 1) / QT, splits, obj_n);
  read_bf16_kernel<<<grid, THREADS, RB_SMEM_BYTES, (cudaStream_t)stream>>>(
      q_map, k_map, v_map, valid, occ_bound, m_part, l_part, acc_part, P, N,
      obj_n / q_planes, chunk, splits, scale);
  return (int)cudaGetLastError();
}

int vft_bank_count_bf16(const void* q, const void* k, const uint8_t* valid,
                        const int* occ_bound, const float* log_thres,
                        float* cnt, int P, int N, int obj_n, int q_planes,
                        int chunk, float scale, void* stream) {
  if (q_planes < 1 || obj_n % q_planes != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map;
  int err = make_map(&q_map, q, DK, P, q_planes, QT);
  if (err == 0) err = make_map(&k_map, k, DK, N, obj_n, 256);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        count_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        CB_SMEM_BYTES);
  if (err != 0) return err;
  count_bf16_kernel<<<sms, THREADS, CB_SMEM_BYTES, (cudaStream_t)stream>>>(
      q_map, k_map, valid, occ_bound, log_thres, cnt, P, N, obj_n,
      obj_n / q_planes, chunk, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
