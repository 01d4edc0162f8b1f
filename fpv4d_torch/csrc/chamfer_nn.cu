// K2: exact brute-force nearest neighbour of Q query points in an
// M-point cloud.
//
// Replaces the TPU kernel _nn_kernel of fpv4d/ops/chamfer_pallas.py
// (launched by _nn_forward there, public entry nn_distance; reached by
// the clip solve through nn.nn_brute). For each query x[q]:
//   d[m] = (dx*dx + dy*dy) + dz*dz  with (dx, dy, dz) = x[q] - y[m],
//   idx[q] = the first m of least d (ties to the smallest index),
//   dist[q] = d[idx[q]],
// bit-identical to nn_distance_plain (ops/chamfer_cuda.py). A leading
// clip axis (the multi-clip fleet's padded scenes, the reference's
// pallas_call under vmap) folds into the tile index: clip c searches its
// own Q queries in its own M-point cloud, in the same launch.
//
// What bounds it on an H100: at the global clip solve's shapes
// (Q = 900 frames x 813 contact vertices = 731,700 queries, M = 100,489
// scene points) it has 7.35e10 pairs against ~16 MB of HBM traffic with
// each input read once and each output written once (5 us at 3.35 TB/s;
// the 1.2 MB cloud that every block re-reads stays in the 50 MB L2).
// It is bound by operations. The floor is the filter's product, K = 16
// bf16 a pair, 32 FLOPs: 2.4 ms at 989 TFLOP/s for these shapes. On the
// CUDA cores each pair costs half an instruction, the sign test's tree
// of three-input ORs (LOP3, which issues at half rate, so about as long
// as one full-rate instruction a pair: 7.35e10 / (132 SMs x 128 lanes x
// 1.98 GHz) = 2.2 ms). The product runs on the tensor cores alongside.
//
// Design: the TPU kernel's folded Gram form, on the tensor cores, as a
// filter with an exact re-check (csrc/gram_nn.cuh holds the margin's
// scalar functions and its proof for the product; the note below carries
// it over to wgmma with the threshold inside the product). One
// persistent block of three warpgroups (384 threads) on each SM walks
// the query tiles in a static order (tile blockIdx.x, then + gridDim.x,
// ...; the clip axis folded in), so there is no wave of whole blocks
// left over. A tile is 384 queries, 128 per warpgroup as two m64 row
// tiles, all centred on the tile's first query; each lane holds its
// rows' A fragments in registers for the whole scan. The cloud streams
// through a ring of 10 shared stages of 256 points: a stage's f32
// coordinates arrive by cp.async into the ring, and the warpgroups take
// turns staging a stage (two points a thread) into wgmma's B layout
// (centred on the tile's centre, |b|^2, bf16 hi/lo) three stages before
// it is used; mbarriers mark a stage full (its four staging warps
// arrived) and empty (all twelve warps done with it). Per stage each
// warpgroup issues, twice, two wgmma m64n128k16 that return F~ - tau
// directly, one value a pair, and tests their sign bits with a tree of
// three-input ORs (half an instruction a pair); the points whose value
// comes out negative are re-evaluated exactly from the stage's f32
// coordinates while it is still in the ring, so dist and idx are those
// of the plain version and no row ever needs a rescan. The products of
// the three warpgroups keep the tensor cores busy while each tests.
//
// What holds it back (measured on an H100 with variants of this file):
// the bare ring of products runs at about two thirds of the tensor
// cores' rate, against nearly all of it for the same products and tests
// without the ring (a warpgroup waits for its own products before it
// tests them: the compiler serializes a warpgroup that reads one
// accumulator set while another is in flight); the staging adds about
// a fifth to it and the sign tests about half (LOP3 issues at half
// rate). PERF.md has the kernel's times.
//
// Threshold in the product (wgmma accumulates in place, so a start at
// -tau would cost a move a value). With x' = [-2a, 1], y' = [b, fl(|b|^2)]
// as in gram_nn.cuh, K = 16:
//   A row    = [x'_hi | x'_hi | x'_lo | -t1  -t2  -t3  0]
//   B column = [y'_hi | y'_lo | y'_hi |  1    1    1   0],
// so one product, started from zero (scale-d 0), is
//   D = fl_tc(F - t1 - t2 - t3),  F = x'_hi.y'_hi + x'_hi.y'_lo + x'_lo.y'_hi,
// where -tau = t1 + t2 + t3 exactly: t1 = bf16(-tau), t2 = bf16(-tau - t1),
// t3 = bf16(-tau - t1 - t2), each difference exact in f32 and the last
// one 8 bits wide (tau's 24 bits in three bf16 parts; a part below
// bf16's normal range falls under the 1e-20 floor). A padded point has
// b = 0, |b|^2 = 1e30 and the same ones, so it never passes; a dead row
// (past Q) has A = [0 ... 0, 1, 0, 0, 0], so D = +1 for every point. A row
// whose threshold tightens re-splits its three A values (lanes t = 2, 3
// of its quad hold k12..15), after a stage in which a lane of its warp
// improved its best; until then the looser threshold only passes more.
//
// Margin for tau inside the sum. The tensor cores multiply bf16 parts
// exactly; the model of their f32 sum (gram_nn.cuh) is an error of at
// most 1.02 * 2^-16 times the sum of the products' magnitudes (8 times
// the bound of a truncating 16-product sum, 16 * 2^-23 = 2^-19), with no
// C operand now: the three t-products are summed with the others. Split
// the error into E_F, that of F's twelve products, which gram_nn.cuh's
// e_a 2|a||b| + e_b |b|^2 already carries, and that of the t-products,
// at most 1.02 * 2^-16 (|t1| + |t2| + |t3|) <= 1.025 * 2^-16 |tau|
// (|t2| <= 2^-8 |tau|, |t3| <= 2^-16 |tau|). For every point m with
// d(m) <= d*, theta(d_ub) bounds F(m) + E_F (gram_nn.cuh, unchanged), and
// tau = theta + 1.03 * 2^-16 |theta| + 1e-20 rounded up (gram::offset), so
//   D <= F + E_F - tau + 1.025 * 2^-16 |tau|
//     <= theta - tau + 1.025 * 2^-16 (|theta| (1 + 2^-15) + 1e-20) < 0,
// its sign bit set: the exact winner and its ties are always re-checked.
// A row with no bound yet carries -tau = -2^126, below every finite
// filter value. Seeding runs the same product with t1..t3 = 0: D is F
// within E_F, which upper_d (gram_nn.cuh) turns into a bound on the
// exact distance, unchanged.
//
// Layouts. A fragments (registers, per warp w of a warpgroup its 16 rows
// of each m64 tile, lane = 4 g + t): a0 row g k (2t, 2t+1), a1 row g + 8
// the same k, a2 row g k (2t+8, 2t+9), a3 row g + 8 the same k, as for
// mma m16n8k16. Accumulators: d[4j + 2h + c] is row g + 8h, column
// 8j + 2t + c. B (shared memory, K-major, no swizzle): a product's 128
// points are 16 groups of 8, 256 bytes each: the core matrix of k 0..7
// (8 points x 16 bytes) then that of k 8..15; the descriptor's leading
// offset (to the next k core matrix) is 128 bytes, its stride offset
// (to the next 8 points) 256.
//
// Seeding. Per tile, 1,024 points spread over the cloud find the
// 1,024-point tile where the tile's first query has its nearest seed;
// the first stages of the scan are that tile again, in seeding mode
// (values only lower each row's running minimum); their least value
// gives every row an upper bound on its best distance (upper_d), and so a
// threshold, before any re-check; then the scan runs over the whole
// cloud from that tile on. Without it, a cloud stored in spatial order
// (a scanned floor, row by row) lowers each row's best step by step and
// re-checks at every step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "gram_nn.cuh"

namespace {

constexpr int kGroups = 3;                 // warpgroups of a block
constexpr int kThreads = kGroups * 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQueries = kGroups * 128;    // two m64 tiles a warpgroup
constexpr int kN = 128;                    // points a product (wgmma N)
constexpr int kSub = 2;                    // products a stage
constexpr int kPts = kSub * kN;            // points a stage
constexpr int kStages = 10;                // the ring
constexpr int kTile = 1024;                // points of a seed tile
constexpr int kSeedProducts = kTile / kN;
constexpr int kStageWords = kN * 32 / 16;  // uint4 of a staged product
constexpr int kMaxDevices = 64;            // devices whose attributes are kept
constexpr float kNoBound = -0x1p126f;  // -tau with no threshold yet
constexpr uint32_t kDeadMark = 0x00003F80u;   // k12 = 1: D = +1

// a stage is loaded kGroups stages before it is staged, and staged
// kGroups stages before it is used
static_assert(kStages > 2 * kGroups + 2, "the ring must outrun the loads");

struct Smem {
  uint4 seed_b[kSeedProducts][kStageWords];  // the spread sample, staged
  uint4 ring_b[kStages][kSub][kStageWords];  // staged stages
  float ring_raw[kStages][3 * kPts];         // their f32 coordinates
  gram::RowState rows[kWarps];
  unsigned long long full[kStages];
  unsigned long long empty[kStages];
  int start_tile;
};

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* b, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(b)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* b,
                                         uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
  }
}

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void copy_word(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// keep the compiler from reading an accumulator set before the wait for
// the wgmma that writes it
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int k = 0; k < 64; ++k) asm volatile("" : "+f"(d[k])::"memory");
}

// descriptor of a staged product (K-major, no swizzle; see the note)
__device__ __forceinline__ uint64_t stage_desc(const uint4* stage) {
  const uint32_t a = smem_addr(stage);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

#define K2_D4(i) "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3])
#define K2_D16(i) K2_D4(i), K2_D4(i + 4), K2_D4(i + 8), K2_D4(i + 12)

// d = A B over 64 rows x 128 points, A from registers, B from shared
// memory; scale-d 0: the product starts from zero, so d is output only
__device__ __forceinline__ void wgmma_128(float (&d)[64], const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : K2_D16(0), K2_D16(16), K2_D16(32), K2_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

#undef K2_D16
#undef K2_D4

// The products of a warpgroup's two m64 tiles against the staged
// product of descriptor desc, issued as one group and awaited. A
// warpgroup that reads one accumulator set while another is in flight is
// serialized by the compiler, so each product is awaited at once; the
// other warpgroups' products keep the tensor cores busy meanwhile.
__device__ __forceinline__ void product(float (&acc)[2][64],
                                        const uint32_t (&a)[2][4],
                                        uint64_t desc) {
  __syncwarp();
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_128(acc[0], a[0], desc);
  wgmma_128(acc[1], a[1], desc);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc[0]);
  fence_acc(acc[1]);
}

__device__ __forceinline__ uint32_t sign_word(float v) {
  return __float_as_uint(v);
}

// a | b | c in one instruction
__device__ __forceinline__ uint32_t or3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xfe;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// ---- staging and rows ----------------------------------------------------

// point n (0..127) of a product: b = y - c (f32), yy = fl(|b|^2) (kPadYY for
// padding) as its two 16-byte rows, k 0..7 and k 8..15
__device__ __forceinline__ void stage_point(uint4* stage, int n, float bx,
                                            float by, float bz, float yy) {
  __nv_bfloat16 h[4], l[4];
  gram::split(bx, h[0], l[0]);
  gram::split(by, h[1], l[1]);
  gram::split(bz, h[2], l[2]);
  gram::split(yy, h[3], l[3]);
  const uint32_t w0 = gram::pack(h[0], h[1]), w1 = gram::pack(h[2], h[3]);
  uint4* row = stage + 16 * (n >> 3) + (n & 7);
  row[0] = make_uint4(w0, w1, gram::pack(l[0], l[1]), gram::pack(l[2], l[3]));
  row[8] = make_uint4(w0, w1, 0x3F803F80u, 0x00003F80u);
}

// stage point n from (px, py, pz) centred on c when `real`, else padding
__device__ __forceinline__ void stage(uint4* st, int n, float px, float py,
                                      float pz, bool real, float cx,
                                      float cy, float cz) {
  float bx = 0.f, by = 0.f, bz = 0.f, yy = gram::kPadYY;
  if (real) {
    bx = __fsub_rn(px, cx);
    by = __fsub_rn(py, cy);
    bz = __fsub_rn(pz, cz);
    yy = __fadd_rn(__fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by)),
                   __fmul_rn(bz, bz));
  }
  stage_point(st, n, bx, by, bz, yy);
}

// -tau in three bf16 parts whose sum is -tau exactly (see the note)
__device__ __forceinline__ void split3(float v, __nv_bfloat16& p1,
                                       __nv_bfloat16& p2,
                                       __nv_bfloat16& p3) {
  if (!(v > kNoBound)) v = kNoBound;
  p1 = __float2bfloat16_rn(v);
  const float r1 = __fsub_rn(v, __bfloat162float(p1));
  p2 = __float2bfloat16_rn(r1);
  p3 = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(p2)));
}

// The lane's view of its four rows: slot r = 2 i + h is row g + 8 h of
// m64 tile i of its warp's warpgroup; in the warp's RowState it is row
// 16 i + g + 8 h (gram_nn.cuh's order).
struct Rows {
  gram::RowState* st;
  int lane;
  uint32_t live;  // bit r: slot r is a query
  __device__ int row(int r) const {
    return 16 * (r >> 1) + (lane >> 2) + 8 * (r & 1);
  }
  __device__ float qx(int r) const { return st->q[0][row(r)]; }
  __device__ float qy(int r) const { return st->q[1][row(r)]; }
  __device__ float qz(int r) const { return st->q[2][row(r)]; }
  __device__ float X(int r) const { return st->X[row(r)]; }
  __device__ float K_lo(int r) const { return st->K_lo[row(r)]; }
  __device__ float& ub(int r) { return st->ub[row(r)]; }
  __device__ float& best(int r) { return st->best[r][lane]; }
  __device__ int& bi(int r) { return st->bi[r][lane]; }
  __device__ int& rechecks(int r) { return st->rechecks[r][lane]; }
};

// Set up the lane's rows and A fragments: slot r holds query
// (qx, qy, qz)[r] and is live when live[r]; (cx, cy, cz) is the centre.
// The threshold parts start at zero (seeding), a dead row's at kDeadMark.
__device__ __forceinline__ void init_rows(Rows& s, gram::RowState* st,
                                          int lane, const float* qx,
                                          const float* qy, const float* qz,
                                          const bool* live, float cx,
                                          float cy, float cz,
                                          uint32_t (&a)[2][4]) {
  s.st = st;
  s.lane = lane;
  s.live = 0;
  const int t = lane & 3;
  __nv_bfloat16 H[4][4], L[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (live[r]) s.live |= 1u << r;
    const float ax = __fsub_rn(qx[r], cx);
    const float ay = __fsub_rn(qy[r], cy);
    const float az = __fsub_rn(qz[r], cz);
    if (st != nullptr) {
      const int w = s.row(r);
      st->q[0][w] = qx[r];
      st->q[1][w] = qy[r];
      st->q[2][w] = qz[r];
      const float k_up = __fadd_ru(__fadd_ru(__fmul_ru(ax, ax),
                                             __fmul_ru(ay, ay)),
                                   __fmul_ru(az, az));
      st->X[w] = __fsqrt_ru(k_up);
      st->K_lo[w] = __fadd_rd(__fadd_rd(__fmul_rd(ax, ax),
                                        __fmul_rd(ay, ay)),
                              __fmul_rd(az, az));
      st->ub[w] = CUDART_INF_F;
      st->best[r][lane] = CUDART_INF_F;
      st->bi[r][lane] = 0;
      st->rechecks[r][lane] = 0;
    }
    const float v[4] = {live[r] ? -2.0f * ax : 0.f,
                        live[r] ? -2.0f * ay : 0.f,
                        live[r] ? -2.0f * az : 0.f, live[r] ? 1.0f : 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k) gram::split(v[k], H[r][k], L[r][k]);
  }
  const bool odd = t & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r0 = 2 * i, r1 = 2 * i + 1;
    a[i][0] = odd ? gram::pack(H[r0][2], H[r0][3])
                  : gram::pack(H[r0][0], H[r0][1]);
    a[i][1] = odd ? gram::pack(H[r1][2], H[r1][3])
                  : gram::pack(H[r1][0], H[r1][1]);
    if (t < 2) {
      a[i][2] = odd ? gram::pack(L[r0][2], L[r0][3])
                    : gram::pack(L[r0][0], L[r0][1]);
      a[i][3] = odd ? gram::pack(L[r1][2], L[r1][3])
                    : gram::pack(L[r1][0], L[r1][1]);
    } else {
      a[i][2] = (t == 2 && !live[r0]) ? kDeadMark : 0u;
      a[i][3] = (t == 2 && !live[r1]) ? kDeadMark : 0u;
    }
  }
}

// Fold -tau of tile I's live slots (neg_tau[h] for slot 2 I + h, the
// same in the quad's lanes) into its A fragments (lanes t = 2, 3).
template <int I>
__device__ __forceinline__ void fold_tau(const Rows& s, const float* neg_tau,
                                         uint32_t (&a)[2][4]) {
  const int t = s.lane & 3;
  if (t < 2) return;
  const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!((s.live >> (2 * I + h)) & 1)) continue;
    __nv_bfloat16 p1, p2, p3;
    split3(neg_tau[h], p1, p2, p3);
    a[I][2 + h] = t == 2 ? gram::pack(p1, p2) : gram::pack(p3, z);
  }
}

// Tile I's thresholds from its two slots' bounds d_ub[h] (slot 2 I + h,
// the same in every lane of the quad): lanes t and t + 2 evaluate slot
// 2 I + (t & 1)'s, the quad shares them, and lane t = 2 folds t1, t2 of
// each live slot's -tau into k12, k13 of its A fragments, lane t = 3 t3
// into k14 (k15 stays 0). Dead slots keep kDeadMark.
template <int I>
__device__ __forceinline__ void tile_thresholds(const Rows& s,
                                                const float* d_ub,
                                                uint32_t (&a)[2][4]) {
  const int t = s.lane & 3, r = 2 * I + (t & 1);
  const float o = gram::offset(
      gram::theta((t & 1) ? d_ub[1] : d_ub[0], s.X(r), s.K_lo(r)));
  float neg_tau[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    neg_tau[h] = __shfl_sync(0xffffffffu, o, (s.lane & ~3) | h);
  fold_tau<I>(s, neg_tau, a);
}

// After tile I's seeding: each slot's bound is upper_d of its quad's
// least filter value, its threshold that bound's (all 32 lanes).
template <int I>
__device__ __forceinline__ void seed_bounds(Rows& s, const float* seed,
                                            uint32_t (&a)[2][4]) {
  float m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fminf(seed[2 * I + h],
                 __shfl_xor_sync(0xffffffffu, seed[2 * I + h], 1));
    m[h] = fminf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
  const int t = s.lane & 3;
  const float u = gram::upper_d((t & 1) ? m[1] : m[0], s.X(2 * I + (t & 1)));
  float d[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    d[h] = __shfl_sync(0xffffffffu, u, (s.lane & ~3) | h);
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) s.ub(2 * I + h) = d[h];
  tile_thresholds<I>(s, d, a);
}

// After a stage that improved a best of tile I somewhere in the warp:
// each of its slots' bound from the best exact distance any lane of its
// quad has, and its threshold (all 32 lanes).
template <int I>
__device__ __forceinline__ void share_bounds(Rows& s, uint32_t (&a)[2][4]) {
  float d[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    d[h] = fminf(s.best(2 * I + h), s.ub(2 * I + h));
    d[h] = fminf(d[h], __shfl_xor_sync(0xffffffffu, d[h], 1));
    d[h] = fminf(d[h], __shfl_xor_sync(0xffffffffu, d[h], 2));
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) s.ub(2 * I + h) = d[h];
  tile_thresholds<I>(s, d, a);
}

// keep the lexicographic least (d, m) as slot r's best
__device__ __forceinline__ void take(Rows& s, int r, float d, int m) {
  float& b = s.best(r);
  int& i = s.bi(r);
  if (d < b || (d == b && m < i)) {
    b = d;
    i = m;
  }
}

// Seeding: tile I's values of a stage only lower its slots' running
// minima seed[2 I + h].
template <int I>
__device__ __forceinline__ void seed_tile(const float (&d)[64], float* seed) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = seed[2 * I + h];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      m = fminf(m, fminf(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));
    seed[2 * I + h] = m;
  }
}

// Tile I's values of one product of the scan: a test of the sign bits of
// the 64 values a lane holds (rows g and g + 8, 32 points each), as two
// halves of 64 points (a tree of ORs), and, for a half with a set bit,
// the re-checks: one value per turn of a loop that all lanes with work
// run together. Returns the slots (bit h: slot 2 I + h) whose best the
// lane improved.
template <int I>
__device__ __forceinline__ uint32_t test_tile(Rows& s, const float (&d)[64],
                                              const float* raw, int base,
                                              int M) {
  uint32_t o[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    uint32_t u0 = 0, u1 = 0;
#pragma unroll
    for (int jj = 0; jj < 8; jj += 2) {
      const int j = 4 * (8 * q + jj);
      u0 |= (sign_word(d[j]) | sign_word(d[j + 1]) | sign_word(d[j + 2])) |
            (sign_word(d[j + 3]) | sign_word(d[j + 4]) |
             sign_word(d[j + 5]));
      u1 |= sign_word(d[j + 6]) | sign_word(d[j + 7]);
    }
    o[q] = u0 | u1;
  }
  if (!((o[0] | o[1]) >> 31)) return 0;
  uint32_t improved = 0;
  const int t = s.lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (!(o[q] >> 31)) continue;
    uint32_t todo = 0;  // bit 16 h + e: value e of slot 2 I + h passes
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          todo |= (sign_word(d[4 * (8 * q + jj) + 2 * h + c]) >> 31)
                  << (16 * h + 2 * jj + c);
    const int col0 = base + 64 * q + 2 * t;
    while (todo != 0) {
      const int bit = __ffs(todo) - 1;
      todo &= todo - 1;
      const int h = bit >> 4, e = bit & 15, r = 2 * I + h;
      const int m = col0 + 8 * (e >> 1) + (e & 1);
      if (m >= M) continue;
      const float* p = raw + 3 * (m - base);
      const float dm = gram::exact_d(s.qx(r), s.qy(r), s.qz(r), p[0], p[1],
                                     p[2]);
      ++s.rechecks(r);
      if (dm < s.best(r)) improved |= 1u << h;
      take(s, r, dm, m);
    }
  }
  return improved;
}

// The lexicographic least (best, bi) of each slot over its quad, and
// each slot's re-check total, in every lane of the quad.
__device__ __forceinline__ void reduce_quad(Rows& s) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, s.best(r), off);
      const int oi = __shfl_xor_sync(0xffffffffu, s.bi(r), off);
      const int on = __shfl_xor_sync(0xffffffffu, s.rechecks(r), off);
      __syncwarp();
      take(s, r, od, oi);
      s.rechecks(r) += on;
      __syncwarp();
    }
  }
}

// ---- the kernel ----------------------------------------------------------

// The scan's stage u of a tile: the start tile's stages first (seeding),
// then the cloud's nst stages from stage s0 on, wrapping.
struct Scan {
  int M, nB, nst, s0, start;  // start = first point of the start tile
  __device__ int base(int u) const {
    if (u < nB) return start + kPts * u;
    int st = s0 + (u - nB);
    if (st >= nst) st -= nst;
    return kPts * st;
  }
};

// The sign bits of every value a lane holds for a stage, ORed with
// three-input ORs (lop3), 64 instructions for 128 values: eight chains
// of 15 values, then a tree over their results and the other eight.
__device__ __forceinline__ uint32_t any_sign(const float (&acc)[2][64]) {
  uint32_t r[16];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float* v = acc[c >> 2] + 16 * (c & 3);
    uint32_t x = or3(sign_word(v[0]), sign_word(v[1]), sign_word(v[2]));
#pragma unroll
    for (int k = 3; k < 15; k += 2)
      x = or3(x, sign_word(v[k]), sign_word(v[k + 1]));
    r[2 * c] = x;
    r[2 * c + 1] = sign_word(v[15]);
  }
  return or3(or3(r[0], r[1], r[2]), or3(r[3], r[4], r[5]),
             or3(r[6], r[7], r[8])) |
         or3(or3(r[9], r[10], r[11]), or3(r[12], r[13], r[14]), r[15]);
}

// A product in which some lane of the warp has a value that passes: the
// re-checks of both tiles, then new thresholds for a tile where a lane
// improved a best (all 32 lanes).
__device__ __forceinline__ void recheck_stage(Rows& s,
                                              const float (&acc)[2][64],
                                              uint32_t (&a)[2][4],
                                              const float* raw, int base,
                                              int M) {
  const uint32_t imp = test_tile<0>(s, acc[0], raw, base, M) |
                       (test_tile<1>(s, acc[1], raw, base, M) << 2);
  __syncwarp();
  const uint32_t any = __reduce_or_sync(0xffffffffu, imp);
  if (any & 3) share_bounds<0>(s, a);
  if (any & 12) share_bounds<1>(s, a);
}

__global__ void __launch_bounds__(kThreads, 1)
chamfer_nn_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ dist, int* __restrict__ idx,
                  int* __restrict__ rechecks, int Q, int M, int C) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_bytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, wq = warp & 3, n_own = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) {
      bar_init(&sm.full[k], 4);
      bar_init(&sm.empty[k], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_q = (Q + kQueries - 1) / kQueries;
  const long long ntiles = static_cast<long long>(tiles_q) * C;
  const int nchunk = (M + gram::kChunk - 1) / gram::kChunk;
  const int nseed = min(kTile / gram::kChunk, nchunk);
  const int nst = (M + kPts - 1) / kPts;
  uint32_t G0 = 0;  // stages of the ring used by earlier tiles
  float acc[2][64];

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int clip = static_cast<int>(tile / tiles_q);
    const int q0 = static_cast<int>(tile % tiles_q) * kQueries;
    const float* xc = x + 3LL * clip * Q;
    const float* yc = y + 3LL * clip * M;
    const float cx = xc[3 * q0], cy = xc[3 * q0 + 1], cz = xc[3 * q0 + 2];

    Rows s;
    uint32_t a[2][4];
    int qi[4];
    {
      bool live[4];
      float qx[4], qy[4], qz[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qi[r] = q0 + 128 * wg + 64 * (r >> 1) + 16 * wq + g + 8 * (r & 1);
        live[r] = qi[r] < Q;
        qx[r] = live[r] ? xc[3 * qi[r]] : 0.f;
        qy[r] = live[r] ? xc[3 * qi[r] + 1] : 0.f;
        qz[r] = live[r] ? xc[3 * qi[r] + 2] : 0.f;
      }
      init_rows(s, &sm.rows[warp], lane, qx, qy, qz, live, cx, cy, cz, a);
    }
    float seed[4] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                     CUDART_INF_F};

    // The spread sample: nseed chunks spread evenly over the cloud give
    // the tile's first query the 1,024-point tile of its nearest seed.
    __syncthreads();  // the previous tile is done with seed_b, start_tile
    for (int p = tid; p < kTile; p += kThreads) {
      const int m = (p / gram::kChunk) * nchunk / nseed * gram::kChunk +
                    p % gram::kChunk;
      const bool real = p < nseed * gram::kChunk && m < M;
      stage(sm.seed_b[p / kN], p % kN, real ? yc[3 * m] : 0.f,
            real ? yc[3 * m + 1] : 0.f, real ? yc[3 * m + 2] : 0.f, real,
            cx, cy, cz);
    }
    fence_async_smem();
    __syncthreads();
    float seed_min = CUDART_INF_F;
    int seed_at = 0;
    for (int k = 0; k < kSeedProducts; ++k) {
      product(acc, a, stage_desc(sm.seed_b[k]));
      seed_tile<0>(acc[0], seed);
      seed_tile<1>(acc[1], seed);
      if (warp == 0) {  // slot 0 of lanes 0..3 is the tile's first query
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float v = fminf(acc[0][4 * j], acc[0][4 * j + 1]);
          if (v < seed_min) {
            seed_min = v;
            seed_at = 4 * k + (j >> 2);
          }
        }
      }
    }
    if (warp == 0) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, seed_min, off);
        const int oa = __shfl_xor_sync(0xffffffffu, seed_at, off);
        if (ov < seed_min || (ov == seed_min && oa < seed_at)) {
          seed_min = ov;
          seed_at = oa;
        }
      }
      if (lane == 0)
        sm.start_tile = (seed_at * nchunk / nseed) * gram::kChunk / kTile;
    }
    __syncthreads();
    Scan sc;
    sc.M = M;
    sc.nst = nst;
    sc.start = sm.start_tile * kTile;
    sc.nB = (min(kTile, M - sc.start) + kPts - 1) / kPts;
    sc.s0 = sm.start_tile * (kTile / kPts);
    const int V = sc.nB + nst;

    // cp.async the f32 coordinates of stage u into its slot, once the
    // slot's earlier stage is done with (a committed group either way)
    const auto load = [&](int u) {
      if (u < V) {
        const uint32_t gu = G0 + u;
        const int slot = gu % kStages;
        if (gu >= kStages) {
          if (lane == 0) bar_wait(&sm.empty[slot], (gu / kStages - 1) & 1);
          __syncwarp();
        }
        const int left = M - sc.base(u);  // points of the stage, if < kPts
        const float* src = yc + 3LL * sc.base(u);
#pragma unroll
        for (int h = 0; h < kSub; ++h) {
          const int n = n_own + kN * h;
          if (n < left)
#pragma unroll
            for (int c = 0; c < 3; ++c)
              copy_word(sm.ring_raw[slot] + 3 * n + c, src + 3 * n + c);
        }
      }
      copies_commit();
    };
    // stage u (its copies, the only ones in flight, landed), then load
    // the copies of the warpgroup's next job
    const auto stage_job = [&](int u) {
      copies_wait();
      if (u < V) {
        const uint32_t gu = G0 + u;
        const int slot = gu % kStages;
        const int left = M - sc.base(u);
#pragma unroll
        for (int h = 0; h < kSub; ++h) {
          const int n = n_own + kN * h;
          const float* p = sm.ring_raw[slot] + 3 * n;
          const bool real = n < left;
          stage(sm.ring_b[slot][h], n_own, real ? p[0] : 0.f,
                real ? p[1] : 0.f, real ? p[2] : 0.f, real, cx, cy, cz);
        }
        fence_async_smem();
        __syncwarp();
        if (lane == 0) bar_arrive(&sm.full[slot]);
      }
      load(u + kGroups);
      __syncwarp();
    };

    // The scan: warpgroup wg stages u = wg, wg + kGroups, ... (its first
    // stage before the scan, then stage v + kGroups after its own test of
    // stage v), while the other warpgroups' products keep the tensor
    // cores busy. The start tile's stages seed; then every stage is
    // tested.
    load(wg);
    stage_job(wg);
    int slot = G0 % kStages, turn = wg == 0 ? 0 : kGroups - wg;
    uint32_t phase = (G0 / kStages) & 1;
    const uint64_t desc0 = stage_desc(sm.ring_b[0][0]);
    // a stage is kSub products of kN points
    const auto step = [&](int v, bool seeding) {
      bar_wait(&sm.full[slot], phase);
#pragma unroll
      for (int h = 0; h < kSub; ++h) {
        const uint64_t desc =
            desc0 + (static_cast<uint64_t>(kSub * slot + h) << 8);
        product(acc, a, desc);
        if (seeding) {
          seed_tile<0>(acc[0], seed);
          seed_tile<1>(acc[1], seed);
        } else if (__any_sync(0xffffffffu, any_sign(acc) >> 31)) {
          recheck_stage(s, acc, a, sm.ring_raw[slot] + 3 * kN * h,
                        sc.base(v) + kN * h, M);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&sm.empty[slot]);
      if (turn == 0) stage_job(v + kGroups);
      turn = turn == kGroups - 1 ? 0 : turn + 1;
      if (++slot == kStages) {
        slot = 0;
        phase ^= 1;
      }
    };
    for (int v = 0; v < sc.nB; ++v) step(v, true);
    seed_bounds<0>(s, seed, a);
    seed_bounds<1>(s, seed, a);
    for (int v = sc.nB; v < V; ++v) step(v, false);

    copies_wait();
    G0 += V;

    reduce_quad(s);
    if (t == 0) {
      const long long c0 = static_cast<long long>(clip) * Q;
      float* dc = dist + c0;
      int* ic = idx + c0;
      int* rc = rechecks == nullptr ? nullptr : rechecks + c0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (!((s.live >> r) & 1)) continue;
        dc[qi[r]] = s.best(r);
        ic[qi[r]] = s.bi(r);
        if (rc != nullptr) rc[qi[r]] = s.rechecks(r);
      }
    }
  }
}

// Test-only: the raw filter values D of queries x[0..Q) (Q <= 384, one
// tile centred on x[0]) against every point of y, with -tau = neg_tau[q]
// folded in as the kernel folds it: out[q * M + m]. The same staging,
// fragments and product as chamfer_nn_kernel, one block.
__global__ void __launch_bounds__(kThreads, 1)
gram_probe_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ neg_tau, float* __restrict__ out,
                  int Q, int M) {
  __shared__ __align__(128) uint4 st[kStageWords];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const float cx = x[0], cy = x[1], cz = x[2];
  Rows s;
  uint32_t a[2][4];
  int qi[4];
  float nt[4];
  {
    bool live[4];
    float qx[4], qy[4], qz[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qi[r] = 128 * wg + 64 * (r >> 1) + 16 * wq + g + 8 * (r & 1);
      live[r] = qi[r] < Q;
      qx[r] = live[r] ? x[3 * qi[r]] : 0.f;
      qy[r] = live[r] ? x[3 * qi[r] + 1] : 0.f;
      qz[r] = live[r] ? x[3 * qi[r] + 2] : 0.f;
      nt[r] = live[r] ? neg_tau[qi[r]] : 0.f;
    }
    init_rows(s, nullptr, lane, qx, qy, qz, live, cx, cy, cz, a);
  }
  fold_tau<0>(s, nt, a);
  fold_tau<1>(s, nt + 2, a);
  float acc[2][64];
  for (int base = 0; base < M; base += kN) {
    if (tid < kN) {
      const int m = base + tid;
      const bool real = m < M;
      stage(st, tid, real ? y[3 * m] : 0.f, real ? y[3 * m + 1] : 0.f,
            real ? y[3 * m + 2] : 0.f, real, cx, cy, cz);
    }
    fence_async_smem();
    __syncthreads();
    product(acc, a, stage_desc(st));
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 2 * i + h, m = base + 8 * j + 2 * t + c;
            if (qi[r] < Q && m < M)
              out[static_cast<long long>(qi[r]) * M + m] =
                  acc[i][4 * j + 2 * h + c];
          }
    __syncthreads();
  }
}

// per device: the multiprocessor count, once the kernel's shared-memory
// attribute is set (0 until the first launch there)
std::atomic<int> device_sms[kMaxDevices];

int prepare(int* sms) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  int n = device_sms[device].load();
  if (n == 0) {
    e = cudaFuncSetAttribute(chamfer_nn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(Smem)));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    device_sms[device].store(n);
  }
  *sms = n;
  return 0;
}

}  // namespace

// Plain C entry for ctypes. All tensors contiguous: x [C,Q,3] f32,
// y [C,M,3] f32, dist [C,Q] f32, idx [C,Q] int32 (each clip's indices
// into its own cloud); rechecks is null or [C,Q] int32, which then
// receives each query's number of exact re-evaluations. Q >= 1, M >= 1,
// 1 <= C <= 65,535 and 3*Q, 3*M < 2^31 (the wrapper checks). One launch
// on `stream`, of one block per multiprocessor or one per tile if there
// are fewer tiles; returns cudaGetLastError() (0 on success). The
// kernel's shared-memory attribute and the multiprocessor count are
// taken on the first launch on each device only, so a launch inside a
// CUDA graph capture makes no other runtime call.
extern "C" int chamfer_nn_forward(const void* x, const void* y, void* dist,
                                  void* idx, void* rechecks, int Q, int M,
                                  int C, void* stream) {
  int sms = 0;
  const int e = prepare(&sms);
  if (e != 0) return e;
  const long long tiles =
      static_cast<long long>((Q + kQueries - 1) / kQueries) * C;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  chamfer_nn_kernel<<<grid, kThreads, sizeof(Smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(dist), static_cast<int*>(idx),
      static_cast<int*>(rechecks), Q, M, C);
  return static_cast<int>(cudaGetLastError());
}

// Test-only entry of gram_probe_kernel: x [Q,3], y [M,3], neg_tau [Q],
// out [Q,M], f32 and contiguous, 1 <= Q <= 384, M >= 1.
extern "C" int chamfer_nn_probe(const void* x, const void* y,
                                const void* neg_tau, void* out, int Q,
                                int M, void* stream) {
  gram_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(neg_tau), static_cast<float*>(out), Q, M);
  return static_cast<int>(cudaGetLastError());
}
