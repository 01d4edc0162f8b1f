// Shared tile routine of the nearest-neighbour kernels K1 (cand_nn.cu)
// and K2 (chamfer_nn.cu): a Gram-form filter on the tensor cores with an
// exact re-check, so the winners stay those of the plain difference form.
//
// The contract both kernels keep is the plain versions' (ops/
// chamfer_cuda.py nn_distance_plain, ops/cand_cuda.py cand_nn_plain): for
// a query x and points y[m], d(m) = (dx*dx + dy*dy) + dz*dz in f32 with
// no FMA contraction, and the winner is the first m of least d(m).
//
// Filter. With a centre c (the block's first query), a = fl(x - c) and
// b = fl(y - c), one bf16 m16n8k16 mma gives for 16 queries x 8 points
//   F~ ~= G = |b|^2 - 2 a.b = |a - b|^2 - |a|^2,
// the folded product x'.y' of the TPU kernels (x' = [-2a, 1],
// y' = [b, fl(|b|^2)]) with each factor split into bf16 hi + lo:
//   A row    = [x'_hi | x'_hi | x'_lo | 0]   (K = 16)
//   B column = [y'_hi | y'_lo | y'_hi | y'_lo],
// so the product is hi.hi + hi.lo + lo.hi (fpv4d/ops/cand_pallas.py:133,
// :156 packs it the same way). The accumulators start at minus each
// row's threshold (offset, below), so the tensor cores return F~ - tau
// and only a test of sign bits stays on the CUDA cores: an OR of three
// values per logic instruction, no minimum.
//
// Margin. Let d* be the exact winner's distance and d_ub >= d* any
// upper bound on it: an exact distance already found, or upper_d (below)
// of a filter value already seen. Every m with d(m) <= d* satisfies
// F~(m) <= theta(d_ub), where (u = 2^-24, X >= |a|, K_lo <= |a|^2):
//   D(m) = |x - y|^2 <= d(m) / (1 - u)^5 <= d_ub (1 + 6u)        (R^2)
//   |(a - b) - (x - y)| <= u (|x - c| + |y - c|)   (centring rounds)
//   |b| <= (X + R) (1 + 4u) = B
//   G(m) <= (R + 1.01u (X + B))^2 - |a|^2
//   |F~ - G| <= e_a 2|a||b| + e_b |b|^2,  e_a = 4.1 * 2^-16,
//                                         e_b = 2.1 * 2^-16,
// where e_a is 3.03 * 2^-16 for the bf16x3 split of each product (the
// dropped lo.lo term and each part's 2^-16 residual) plus 1.02 * 2^-16
// for the tensor cores' f32 accumulation, and e_b adds the "1" column's
// 2^-16 split, that accumulation and fl(|b|^2)'s 3u. The accumulation
// term is 8 times the bound of a 16-product sum whose aligned products
// and result are each truncated to f32's 24 bits (16 * 2^-23 = 2^-19):
// that factor of 8 is the slack taken for the tensor cores' adder. So
//   theta(d_ub) = d_ub - K_lo + 6u d_ub + 2.02u (X + B)(R + u (X + B))
//                 + e_a 2 X B + e_b B^2 + 1e-20,
// computed with upward-rounded intrinsics (K_lo with downward ones,
// square roots with sqrt_up), so the f32 evaluation never falls below
// the real bound; 1e-20 covers
// subnormal flushes and underflow in the splits, in the tensor cores
// and in the squares of the exact form. A point with
// F~(m) > theta(d_ub) therefore has d(m) > d* and is skipped safely;
// every other one is re-evaluated exactly from the f32 coordinates in
// the plain version's order, and the exact best is kept as the
// lexicographic least (d, m), so ties go to the smallest index in any
// visiting order. theta only shrinks as d_ub does.
//
// Layout (m16n8k16, lane = 4 g + t): A fragments hold rows g and g + 8
// of each 16-query tile, k pairs (2t, 2t+1) and (2t+8, 2t+9); B
// fragments column g, the same k pairs; accumulators rows g, g + 8 and
// columns 2t, 2t+1. A chunk is 32 points (four n8 tiles) staged as 256
// words: W_t(p), the k pair (2t, 2t+1) of point p's column, twice, since
// the B fragment's second register repeats its first (k 8..15 repeat
// k 0..7: the hi pairs meet A's lo part, the lo pairs its zeros). Lane
// (g, t) reads W_t of points g, 8+g, 16+g, 24+g as two 16-byte shared
// loads, each a contiguous 512 bytes across the warp, whose register
// pairs are the B fragments as they are: no move, no select.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace gram {

constexpr int kChunk = 32;        // points per chunk: four n8 tiles
constexpr int kChunkFrags = 64;   // uint4 words of a staged chunk
constexpr int kRowsPerWarp = 32;  // two m16 tiles
constexpr int kRows = 4;          // query rows each lane holds
constexpr float kU = 5.9604645e-8f;              // 2^-24
constexpr float kEa = 4.1f * 1.52587890625e-5f;  // 4.1 * 2^-16
constexpr float kEb = 2.1f * 1.52587890625e-5f;  // 2.1 * 2^-16
constexpr float kAbs = 1e-20f;    // absolute floor of the margin
constexpr float kPadYY = 1e30f;   // |y|^2 of padded or invalid points

// the plain versions' difference form, unfused
__device__ __forceinline__ float exact_d(float qx, float qy, float qz,
                                         float px, float py, float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// an upper bound on sqrt(x), x >= 0: x rsqrt(x) is within 2^-21 of it
// (rsqrtf is within 2 ulp), so (1 + 2^-20) and upward rounding cover it
__device__ __forceinline__ float sqrt_up(float x) {
  if (!(x < CUDART_INF_F)) return CUDART_INF_F;
  if (!(x > 1e-30f)) return 1e-15f;
  return __fmul_ru(__fmul_ru(x, rsqrtf(x)), 1.0f + 9.5367431640625e-7f);
}

// the margin's threshold on F~ for a row whose best exact distance is
// at most d_ub (see the note above); +inf while no distance is known
__device__ __forceinline__ float theta(float d_ub, float X, float K_lo) {
  if (!(d_ub < CUDART_INF_F)) return CUDART_INF_F;
  const float R = sqrt_up(__fmul_ru(d_ub, 1.0f + 6.0f * kU));
  const float B = __fmul_ru(__fadd_ru(X, R), 1.0f + 4.0f * kU);
  const float XB = __fadd_ru(X, B);
  float m = __fmul_ru(6.0f * kU, d_ub);
  m = __fadd_ru(m, __fmul_ru(__fmul_ru(2.02f * kU, XB),
                             __fadd_ru(R, __fmul_ru(kU, XB))));
  m = __fadd_ru(m, __fmul_ru(2.0f * kEa, __fmul_ru(X, B)));
  m = __fadd_ru(m, __fmul_ru(kEb, __fmul_ru(B, B)));
  m = __fadd_ru(m, kAbs);
  return __fadd_ru(__fsub_ru(d_ub, K_lo), m);
}

__device__ __forceinline__ void split(float v, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));  // v - hi is exact
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo_k,
                                         __nv_bfloat16 hi_k) {
  return (uint32_t)__bfloat16_as_ushort(lo_k) |
         ((uint32_t)__bfloat16_as_ushort(hi_k) << 16);
}

// Store point p (0..31) of a chunk: b = y - c (f32), yy = fl(|b|^2)
// (kPadYY for a padded or invalid point) as its four words W_0..W_3,
// each twice (the B fragment's two registers).
__device__ __forceinline__ void stage_point(uint32_t* chunk_words, int p,
                                            float bx, float by, float bz,
                                            float yy) {
  __nv_bfloat16 h[4], l[4];
  split(bx, h[0], l[0]);
  split(by, h[1], l[1]);
  split(bz, h[2], l[2]);
  split(yy, h[3], l[3]);
  const uint32_t w[4] = {pack(h[0], h[1]), pack(h[2], h[3]),
                         pack(l[0], l[1]), pack(l[2], l[3])};
  const int g = p & 7, j = p >> 3;
  // lane 4g + t reads words 128 (j >> 1) + 4 (4g + t) + 2 (j & 1) + {0, 1}
  uint32_t* d = chunk_words + 128 * (j >> 1) + 16 * g + 2 * (j & 1);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    d[4 * t] = w[t];
    d[4 * t + 1] = w[t];
  }
}


// Stage point p of a staged run of chunks: (px, py, pz) centred on c
// when `real`, else padding (b = 0, |b|^2 = kPadYY, which never passes).
__device__ __forceinline__ void stage(uint32_t* words, int p, float px,
                                      float py, float pz, bool real,
                                      float cx, float cy, float cz) {
  float bx = 0.f, by = 0.f, bz = 0.f, yy = kPadYY;
  if (real) {
    bx = __fsub_rn(px, cx);
    by = __fsub_rn(py, cy);
    bz = __fsub_rn(pz, cz);
    yy = __fadd_rn(__fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by)),
                   __fmul_rn(bz, bz));
  }
  stage_point(words + (p / kChunk) * 4 * kChunkFrags, p % kChunk, bx, by,
              bz, yy);
}

// d = A B + C; c is the lane's accumulator fragment of C
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1,
                                         const float* c) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// What a warp keeps of its 32 query rows in shared memory: the queries
// and their bounds by warp row, and each lane's own best so far by
// (row slot r, lane). Only the tests of the hot loop need registers
// (the thresholds and the A fragments), so more warps fit on an SM.
struct RowState {
  float q[3][32];        // the queries, f32
  float X[32], K_lo[32];  // >= |x - c| and <= |x - c|^2
  float ub[32];          // an upper bound on the row's best distance
  float best[4][32];     // each lane's exact best of its columns
  int bi[4][32];
  int rechecks[4][32];   // each lane's exact evaluations
};

// The lane's view of its four rows: rows g, g+8 of the warp's first m16
// tile, then of its second (slot r -> warp row 16 (r >> 1) + g +
// 8 (r & 1)). The four lanes of a quad hold the same rows and split the
// columns.
struct Rows {
  RowState* st;
  int lane;
  // the accumulators' start, as the C fragment of each m16 tile: slot r
  // holds off[r >> 1][2 (r & 1)] and [+ 1], -tau(theta(min(best, ub)));
  // a value passes when F~ - tau < 0; +inf on a dead row
  float off[2][4];
  uint32_t a[2][4];  // A fragments of the two m16 tiles
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
  __device__ float get_off(int r) const { return off[r >> 1][2 * (r & 1)]; }
  __device__ void set_off(int r, float v) {
    off[r >> 1][2 * (r & 1)] = v;
    off[r >> 1][2 * (r & 1) + 1] = v;
  }
};

// An upper bound on the exact distance d(m) of any point m whose filter
// value is v (csrc note: |b| from v, then |a - b|, |x - y| and d):
//   |b| <= B_v = ((1 + e_a) X + sqrt((1 + e_a)^2 X^2 + max(v, 0)))
//                / (1 - e_b),
//   |a - b|^2 <= S^2 = v + e_a 2 X B_v + e_b B_v^2 + X^2,
//   d(m) <= (S + 1.01u (X + B_v))^2 (1 + 6u) + 1e-20,
// with (1 + 2^-13) for 1 + e_a and for 1 / (1 - e_b), and upward
// rounding throughout; +inf for v = +inf.
__device__ __forceinline__ float upper_d(float v, float X) {
  if (!(v < CUDART_INF_F)) return CUDART_INF_F;
  const float ax = __fmul_ru(1.0f + 1.220703125e-4f, X);
  const float Bv = __fmul_ru(
      __fadd_ru(ax, sqrt_up(__fadd_ru(__fmul_ru(ax, ax), fmaxf(v, 0.f)))),
      1.0f + 1.220703125e-4f);
  float s2 = __fadd_ru(v, __fmul_ru(__fmul_ru(2.0f * kEa, X), Bv));
  s2 = __fadd_ru(s2, __fmul_ru(kEb, __fmul_ru(Bv, Bv)));
  s2 = __fadd_ru(s2, __fmul_ru(X, X));
  const float S = __fadd_ru(sqrt_up(fmaxf(s2, 0.f)),
                            __fmul_ru(1.01f * kU, __fadd_ru(X, Bv)));
  return __fadd_ru(__fmul_ru(__fmul_ru(S, S), 1.0f + 6.0f * kU), kAbs);
}

// Set up the lane's rows: row slot r holds query (qx, qy, qz)[r] and is
// live when live[r]; (cx, cy, cz) is the centre. Each lane of a quad
// writes the same shared values, so each reads back its own writes.
__device__ __forceinline__ void init_rows(Rows& s, RowState* st, int lane,
                                          const float* qx, const float* qy,
                                          const float* qz, const bool* live,
                                          float cx, float cy, float cz) {
  s.st = st;
  s.lane = lane;
  const int t = lane & 3;
  __nv_bfloat16 H[kRows][4], L[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int w = s.row(r);
    st->q[0][w] = qx[r];
    st->q[1][w] = qy[r];
    st->q[2][w] = qz[r];
    const float ax = __fsub_rn(qx[r], cx);
    const float ay = __fsub_rn(qy[r], cy);
    const float az = __fsub_rn(qz[r], cz);
    const float k_up = __fadd_ru(__fadd_ru(__fmul_ru(ax, ax),
                                           __fmul_ru(ay, ay)),
                                 __fmul_ru(az, az));
    st->X[w] = __fsqrt_ru(k_up);
    st->K_lo[w] = __fadd_rd(__fadd_rd(__fmul_rd(ax, ax), __fmul_rd(ay, ay)),
                            __fmul_rd(az, az));
    st->ub[w] = CUDART_INF_F;
    st->best[r][lane] = CUDART_INF_F;
    st->bi[r][lane] = 0;
    st->rechecks[r][lane] = 0;
    s.set_off(r, live[r] ? -CUDART_INF_F : CUDART_INF_F);
    const float v[4] = {live[r] ? -2.0f * ax : 0.f,
                        live[r] ? -2.0f * ay : 0.f,
                        live[r] ? -2.0f * az : 0.f, live[r] ? 1.0f : 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], H[r][i], L[r][i]);
  }
  const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r0 = 2 * i, r1 = 2 * i + 1;
    // k pair (2t, 2t+1) of [H | H | L | 0]: elements 0, 1 for even t,
    // 2, 3 for odd t; of L only for t < 2
    const bool odd = t & 1;
    s.a[i][0] = odd ? pack(H[r0][2], H[r0][3]) : pack(H[r0][0], H[r0][1]);
    s.a[i][1] = odd ? pack(H[r1][2], H[r1][3]) : pack(H[r1][0], H[r1][1]);
    const uint32_t l0 = odd ? pack(L[r0][2], L[r0][3])
                            : pack(L[r0][0], L[r0][1]);
    const uint32_t l1 = odd ? pack(L[r1][2], L[r1][3])
                            : pack(L[r1][0], L[r1][1]);
    s.a[i][2] = t < 2 ? l0 : pack(z, z);
    s.a[i][3] = t < 2 ? l1 : pack(z, z);
  }
}

// keep the lexicographic least (d, m) as row slot r's best
__device__ __forceinline__ void take(Rows& s, int r, float d, int m) {
  float& b = s.best(r);
  int& i = s.bi(r);
  if (d < b || (d == b && m < i)) {
    b = d;
    i = m;
  }
}

// The accumulators' start -tau for a threshold theta on F~: tau =
// theta + 1.03 * 2^-16 |theta| + 1e-20, rounded up, covers the tensor
// cores' error relative to |tau| once tau sits in the sum (the same
// 8-fold slack as the e_a, e_b accumulation terms), so F~ <= theta
// implies fl(A B - tau) < 0, its sign bit set. -inf while theta is
// +inf: every value passes.
__device__ __forceinline__ float offset(float theta) {
  return -__fadd_ru(__fadd_ru(theta, __fmul_ru(1.03f * 1.52587890625e-5f,
                                               fabsf(theta))),
                    kAbs);
}

// Row slot r's threshold from the bound d_ub (the same in every lane of
// the quad); lane t of the quad evaluates theta for slot t and the quad
// shares the four results, so theta costs each lane once.
__device__ __forceinline__ void set_thresholds(Rows& s, const float* d_ub) {
  const int t = s.lane & 3;
  const float d = t == 0 ? d_ub[0] : t == 1 ? d_ub[1] : t == 2 ? d_ub[2]
                                                              : d_ub[3];
  const float o = offset(theta(d, s.X(t), s.K_lo(t)));
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = __shfl_sync(0xffffffffu, o, (s.lane & ~3) | r);
    if (s.get_off(r) < CUDART_INF_F) s.set_off(r, v);
  }
}

// The filter values of one chunk of 32 points, less tau when c holds
// the rows' offsets as C fragments (zeros for the values themselves):
// eight mma; v[r][e] is row r's value of column 8 (e >> 1) + 2t +
// (e & 1).
__device__ __forceinline__ void chunk_values(const Rows& s,
                                             const uint4* frags,
                                             const float (*c)[4],
                                             float (*v)[8]) {
  const uint4 u0 = frags[s.lane];
  const uint4 u1 = frags[32 + s.lane];
  const uint32_t b[4][2] = {{u0.x, u0.y}, {u0.z, u0.w}, {u1.x, u1.y},
                            {u1.z, u1.w}};
  float acc[2][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mma_bf16(acc[i][j], s.a[i], b[j][0], b[j][1], c[i]);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = r >> 1, h = (r & 1) * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[r][2 * j] = acc[i][j][h];
      v[r][2 * j + 1] = acc[i][j][h + 1];
    }
  }
}

// the least of a chunk's eight values of one row: a tree, three deep
__device__ __forceinline__ float min8(const float* u) {
  return fminf(fminf(fminf(u[0], u[1]), fminf(u[2], u[3])),
               fminf(fminf(u[4], u[5]), fminf(u[6], u[7])));
}

// Seeding: a chunk's filter values only lower each row's running
// minimum seed[r] (no re-check); returns row 0's minimum over the chunk.
__device__ __forceinline__ float seed_chunk(const Rows& s,
                                            const uint4* frags,
                                            float* seed) {
  const float zero[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float v[kRows][8];
  chunk_values(s, frags, zero, v);
#pragma unroll
  for (int r = 0; r < kRows; ++r) seed[r] = fminf(seed[r], min8(v[r]));
  return min8(v[0]);
}

// After seeding: each row's bound ub becomes upper_d of the quad's least
// filter value, an exact distance some point reaches or undercuts, and
// its threshold that bound's theta, before any re-check (all 32 lanes
// call this).
__device__ __forceinline__ void seed_bounds(Rows& s, const float* seed) {
  const int t = s.lane & 3;
  float a[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    a[r] = fminf(seed[r], __shfl_xor_sync(0xffffffffu, seed[r], 1));
    a[r] = fminf(a[r], __shfl_xor_sync(0xffffffffu, a[r], 2));
  }
  const float mine = t == 0 ? a[0] : t == 1 ? a[1] : t == 2 ? a[2] : a[3];
  const float u = upper_d(mine, s.X(t));
  float d[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    d[r] = __shfl_sync(0xffffffffu, u, (s.lane & ~3) | r);
    s.ub(r) = d[r];
  }
  set_thresholds(s, d);
}

// One chunk of 32 points, indices base .. base + 31 (those >= limit are
// padding): eight mma that return F~ - tau, one test of their sign bits
// and, rarely, the re-check. The lane re-checks each value that passes
// (a set sign bit), one per turn of a loop that all lanes with work run
// together, then tightens the thresholds of the rows it improved, one
// row per turn likewise. `exact(qx, qy, qz, m)` returns the plain
// version's value for point m.
template <class Exact>
__device__ __forceinline__ void chunk(Rows& s, const uint4* frags,
                                      int base, int limit,
                                      const Exact& exact) {
  float v[kRows][8];
  chunk_values(s, frags, s.off, v);
  // the OR of all sign bits, as a tree of three-input ORs: no minimum
  uint32_t o[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float* u = v[r];
    o[r] = (__float_as_uint(u[0]) | __float_as_uint(u[1]) |
            __float_as_uint(u[2])) |
           (__float_as_uint(u[3]) | __float_as_uint(u[4]) |
            __float_as_uint(u[5])) |
           (__float_as_uint(u[6]) | __float_as_uint(u[7]));
  }
  if (!((o[0] | o[1] | o[2] | o[3]) >> 31)) return;
  uint32_t todo = 0;  // bit 8 r + e: value e of row r passes
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      todo |= (__float_as_uint(v[r][e]) >> 31) << (8 * r + e);
  uint32_t improved = 0;
  const int col0 = base + 2 * (s.lane & 3);
  while (todo != 0) {
    const int bit = __ffs(todo) - 1;
    todo &= todo - 1;
    const int r = bit >> 3, e = bit & 7;
    const int m = col0 + 8 * (e >> 1) + (e & 1);
    if (m >= limit) continue;
    const float d = exact(s.qx(r), s.qy(r), s.qz(r), m);
    ++s.rechecks(r);
    if (d < s.best(r)) improved |= 1u << r;
    take(s, r, d, m);
  }
  while (improved != 0) {  // one theta per turn, all lanes together
    const int r = __ffs(improved) - 1;
    improved &= improved - 1;
    const float o = offset(theta(fminf(s.best(r), s.ub(r)), s.X(r),
                                 s.K_lo(r)));
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      if (rr == r) s.set_off(rr, o);
  }
}

// All chunks [0, nchunks) of a staged tile.
template <class Exact>
__device__ __forceinline__ void tile(Rows& s, const uint4* frags,
                                     int nchunks, int base, int limit,
                                     const Exact& exact) {
  for (int k = 0; k < nchunks; ++k)
    chunk(s, frags + k * kChunkFrags, base + k * kChunk, limit, exact);
}

// After a tile: each row's bound and threshold from the best exact
// distance any lane of its quad has found (all 32 lanes call this).
__device__ __forceinline__ void share_bounds(Rows& s) {
  float d[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    d[r] = fminf(s.best(r), s.ub(r));
    d[r] = fminf(d[r], __shfl_xor_sync(0xffffffffu, d[r], 1));
    d[r] = fminf(d[r], __shfl_xor_sync(0xffffffffu, d[r], 2));
    s.ub(r) = d[r];
  }
  set_thresholds(s, d);
}

// The lexicographic least (best, bi) of each row over its quad, and
// each row's re-check total, in every lane of the quad (all lanes call
// it).
__device__ __forceinline__ void reduce_quad(Rows& s) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, s.best(r), off);
      const int oi = __shfl_xor_sync(0xffffffffu, s.bi(r), off);
      const int on = __shfl_xor_sync(0xffffffffu, s.rechecks(r), off);
      take(s, r, od, oi);
      s.rechecks(r) += on;
    }
  }
}

}  // namespace gram
