// Fused site epilogue of the one-site sweep: the Newton-Schulz polar gauge
// of the (d*chi, chi) panel and the environment growth, one launch for the
// whole batch, on one of two routes (ops/kernels.py gauge_env_route).
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_fused_gauge_env (the
// function that reaches its pallas_call), called through
// fused_gauge_env_left / fused_gauge_env_right.
//
// Semantics (per instance, kernel layout): W (M,M,d,d) shared by the batch,
// E (M,chi,chi) [w](in, out), A (d*chi, chi) with rows s-major, X_s the
// rows s*chi ... s*chi+chi-1 of X:
//   X = A / (|A|_F * 1.01 + 1e-30)
//   quintic steps: G = X^T X;  X = 3.4445 X + X (-4.7750 G + 2.0315 G G)
//   cubic steps:   G = X^T X;  X = 1.5 X - 0.5 X G
//   Q = X;  P = X^T A
//   U[w*d+t] = X_t^T E_w;  Enew_v = sum_s (sum_{w,t} W[w,v,s,t] U[w*d+t]) X_s
// in the TPU kernel's order of operations (not ns_polar's).
//
// What bounds it on the H100: operations.  At chi=64, d=2, M=3 an instance
// does ~59 MFLOP (14 quintic steps of 2.6, 7 cubic of 2.1, P, U and Enew)
// against ~0.2 MB in and out: 0.224 ms at B=256 on fp32 SIMT (67 TFLOP/s),
// 0.091 ms in 3xTF32 on the tensor cores (3 x flops at 495 TFLOP/s).
// What limits it in practice is the chain of 21 dependent steps, each a few
// small GEMMs.
//
// Route "resident" (f32, chi padded to CP = 32, 64, 96 or 128 where the
// footprint below fits one block): the TPU kernel's design, one block per
// instance with the panel resident on the SM for all 21 steps.  Dynamic
// shared memory holds
//   X   the panel, d*CP rows at pitch CP + 8 (= 8 mod 32 words),
//   G   one CP x CP matrix at pitch CP + 4 (= 4 mod 32): G, then Mx over
//       it, and at the end the staging of A_s, E_w and Q_vs,
//   the couplings and 33 doubles of block sums:
//   bytes = 272 + 4 (d CP (CP + 8) + CP (CP + 4) + M^2 d^2) <= 232,448,
// so d=2, M=3 takes chi <= 128 (207,264 bytes at CP=128; 54,688 at
// chi=64, two blocks an SM by registers: B=256 is one wave on 132 SMs).
// Stages are separated by __syncthreads() only; no iterate goes to device
// memory.  X is updated in place: a row block of X' = a X + b X F needs
// only the same rows of X, so the warps sum a row block in registers
// (128 x 64 at chi=64, 32 floats a thread), the block syncs, and each
// thread writes its own outputs.  Mx overwrites G the same way: G G is
// summed in registers, the block syncs, Mx = b G + c G G is written.
// After the polar, Q and P = sum_s X_s^T A_s (A_s staged into G) are
// written, U = X_t^T E_w (E_w staged into G) goes to a device scratch,
// and Enew_v = sum_s Q_vs X_s takes each Q_vs = sum W U as the couplings
// are folded in while it is staged into G (zero couplings skipped).
// Products: 3xTF32 m16n8k8 mma.sync (gemm_tc32.cuh's split and mma), each
// 8-deep step's three products summed from zero and added to the
// accumulator in f32, so each value passes one round-toward-zero of the
// tensor cores per 8-deep sum (the 21 polar steps would carry a chained
// bias into |Q^T Q - I| and P).  Operand layout: X^T X and X^T Y read X
// k-major, X F reads it by rows.  At pitch = 8 (mod 32) a k-major fragment
// load (rows k0+q, columns g) hits 32 banks; a row read does too when the
// 8-deep step's positions q and q+4 hold k = 2q and 2q+1, one 8-byte load
// (the B operand F, at pitch = 4 (mod 32), follows that order without a
// conflict).  G G and the tail products have one 2-way conflicted operand.
// |A|^2 is summed in f64 by each thread and a fixed block tree: no float
// atomics, so a repeat launch gives the same bits.
//
// Route "grid" (every chi up to the admission, chi <= 347 at d=2, M=3, and
// every f64 call): the panel alone is 128 KB at chi=128 and 512 KB at
// chi=256, so the iterates live in device memory (mostly L2),
// ping-ponging between Q and a scratch panel so that the last one lands in
// Q; only GEMM operand chunks and the couplings are staged through shared
// memory.  One cooperative launch runs every step of every instance: the
// blocks walk the 64x64 output tiles of each stage over the whole batch,
// with grid.sync() between dependent stages (3 per quintic step, 2 per
// cubic).  The transposed operands of X^T Y are staged k-major, so
// neighbouring threads read neighbouring addresses.  The couplings are
// folded into the A operand of Enew while it is staged (heff::LoadQ, as in
// K1's stage 2).  The norm is summed from fixed partial slots in a fixed
// order: no float atomics.  fp32/fp64 SIMT (heff.cuh).
#include <cooperative_groups.h>

#include "gemm_tc32.cuh"

namespace {

namespace cg = cooperative_groups;
using heff::KC;
using heff::SUB;
using heff::THREADS;
using heff::TILE;

constexpr int SEG = THREADS * 16;  // elements per norm-partial job (4096)

template <typename T>
struct Args {
  const T* W;     // (M,M,d,d)
  const T* E;     // (B,M,chi,chi)
  const T* A;     // (B,d*chi,chi)
  T* Q;           // (B,d*chi,chi) out
  T* P;           // (B,chi,chi) out
  T* Enew;        // (B,M,chi,chi) out
  T* X2;          // scratch (B,d*chi,chi): the other iterate buffer
  T* G;           // scratch (B,chi,chi)
  T* Mx;          // scratch (B,chi,chi)
  T* U;           // scratch (B,M*d,chi,chi)
  T* part;        // scratch (B,nseg): |A|^2 partials
  int B, chi, d, M, quintic, cubic;
};

// acc += A^T[r0:r0+64, :K] @ Bm[:K, c0:c0+64], A (K x lda) row-major: the
// product X^T Y of two panels.  The A^T chunk is staged k-major (rows of A
// are contiguous), unlike heff::tile_gemm's.  Ends with a __syncthreads().
template <typename T>
__device__ void tile_gemm_tn(T (&acc)[SUB][SUB], const T* A, int lda,
                             const T* Bm, int ldb, int K, int n_rows,
                             int n_cols, int r0, int c0, heff::Smem<T>& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int e = tid; e < KC * TILE; e += THREADS) {
      const int k = e / TILE, r = e % TILE;
      const int gk = k0 + k, gr = r0 + r, gc = c0 + r;
      sm.a[k][r] = (gk < K && gr < n_rows) ? A[(size_t)gk * lda + gr] : T(0);
      sm.b[k][r] = (gk < K && gc < n_cols) ? Bm[(size_t)gk * ldb + gc] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      T av[SUB], bv[SUB];
#pragma unroll
      for (int i = 0; i < SUB; ++i) av[i] = sm.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < SUB; ++j) bv[j] = sm.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < SUB; ++i)
#pragma unroll
        for (int j = 0; j < SUB; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
}

// C = alpha * S + beta * acc over this thread's outputs (masked); S and C
// share the leading dimension ld.
template <typename T>
__device__ void store_axpby(const T (&acc)[SUB][SUB], T alpha, const T* S,
                            T beta, T* C, int ld, int n_rows, int n_cols,
                            int r0, int c0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < n_cols) {
        const size_t o = (size_t)r * ld + c;
        C[o] = alpha * S[o] + beta * acc[i][j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gauge_env_kernel(Args<T> a) {
  __shared__ heff::Smem<T> sm;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, nb = gridDim.x, bid = blockIdx.x;
  const int chi = a.chi, d = a.d, M = a.M;
  const size_t plane = (size_t)chi * chi, panel = d * plane;
  const int nt = heff::num_tiles(chi);
  const int sq = nt * nt;                                // chi x chi tiles
  const int pt = ((d * chi + TILE - 1) / TILE) * nt;     // panel tiles
  const int nseg = (int)((panel + SEG - 1) / SEG);
  const int steps = a.quintic + a.cubic;
  // the iterate X_j lives in buf(j), so that X_steps lands in Q
  auto buf = [&](int j) -> T* { return ((steps - j) & 1) ? a.X2 : a.Q; };
  auto tile_origin = [&](int tile, int& r0, int& c0) {
    r0 = (tile / nt) * TILE;
    c0 = (tile % nt) * TILE;
  };

  heff::load_couplings(a.W, d, M, sm);

  // X_0 = A / (|A| * 1.01 + 1e-30), |A|^2 from per-segment partials
  for (int job = bid; job < a.B * nseg; job += nb) {
    const int b = job / nseg, s = job % nseg;
    const T* A = a.A + b * panel;
    T p = T(0);
    for (int k = 0; k < SEG / THREADS; ++k) {
      const size_t e = (size_t)s * SEG + (size_t)k * THREADS + tid;
      if (e < panel) p += A[e] * A[e];
    }
    p = heff::block_sum(p, sm);
    if (tid == 0) a.part[(size_t)b * nseg + s] = p;
  }
  grid.sync();
  for (int job = bid; job < a.B * nseg; job += nb) {
    const int b = job / nseg, s = job % nseg;
    const T nrm = sqrt(heff::ordered_sum(a.part + (size_t)b * nseg, nseg, sm));
    const T inv = T(1) / (nrm * T(1.01) + T(1e-30));
    const T* A = a.A + b * panel;
    T* X = buf(0) + b * panel;
    for (int k = 0; k < SEG / THREADS; ++k) {
      const size_t e = (size_t)s * SEG + (size_t)k * THREADS + tid;
      if (e < panel) X[e] = A[e] * inv;
    }
  }
  grid.sync();

  for (int j = 0; j < steps; ++j) {
    const bool quintic = j < a.quintic;
    const T* X = buf(j);
    T* Xn = buf(j + 1);
    // G = X^T X
    for (int job = bid; job < a.B * sq; job += nb) {
      const int b = job / sq;
      int r0, c0;
      tile_origin(job % sq, r0, c0);
      const T* Xb = X + b * panel;
      T acc[SUB][SUB];
      heff::zero_acc(acc);
      tile_gemm_tn(acc, Xb, chi, Xb, chi, d * chi, chi, chi, r0, c0, sm);
      heff::store_tile(acc, a.G + b * plane, chi, chi, chi, r0, c0);
    }
    grid.sync();
    const T* F = a.G;  // the right factor of the update
    if (quintic) {
      // Mx = b G + c G G
      for (int job = bid; job < a.B * sq; job += nb) {
        const int b = job / sq;
        int r0, c0;
        tile_origin(job % sq, r0, c0);
        const T* Gb = a.G + b * plane;
        T acc[SUB][SUB];
        heff::zero_acc(acc);
        heff::tile_gemm(acc, heff::LoadPlain<T>{Gb, chi}, Gb, chi, chi, chi,
                        chi, r0, c0, sm);
        store_axpby(acc, T(-4.7750), Gb, T(2.0315), a.Mx + b * plane, chi,
                    chi, chi, r0, c0);
      }
      grid.sync();
      F = a.Mx;
    }
    // quintic: X' = a X + X Mx;  cubic: X' = 1.5 X - 0.5 X G
    const T alpha = quintic ? T(3.4445) : T(1.5);
    const T beta = quintic ? T(1) : T(-0.5);
    for (int job = bid; job < a.B * pt; job += nb) {
      const int b = job / pt;
      int r0, c0;
      tile_origin(job % pt, r0, c0);
      const T* Xb = X + b * panel;
      T acc[SUB][SUB];
      heff::zero_acc(acc);
      heff::tile_gemm(acc, heff::LoadPlain<T>{Xb, chi}, F + b * plane, chi,
                      chi, d * chi, chi, r0, c0, sm);
      store_axpby(acc, alpha, Xb, beta, Xn + b * panel, chi, d * chi, chi, r0,
                  c0);
    }
    grid.sync();
  }

  // P = X^T A and U[w*d+t] = X_t^T E_w: independent, one job list
  const T* X = a.Q;
  const int ujobs = M * d * sq, jobs3 = sq + ujobs;
  for (int job = bid; job < a.B * jobs3; job += nb) {
    const int b = job / jobs3, r = job % jobs3;
    const T* Xb = X + b * panel;
    int r0, c0;
    T acc[SUB][SUB];
    heff::zero_acc(acc);
    if (r < sq) {
      tile_origin(r, r0, c0);
      tile_gemm_tn(acc, Xb, chi, a.A + b * panel, chi, d * chi, chi, chi, r0,
                   c0, sm);
      heff::store_tile(acc, a.P + b * plane, chi, chi, chi, r0, c0);
    } else {
      const int wt = (r - sq) / sq, w = wt / d, t = wt % d;
      tile_origin((r - sq) % sq, r0, c0);
      tile_gemm_tn(acc, Xb + t * plane, chi, a.E + ((size_t)b * M + w) * plane,
                   chi, chi, chi, chi, r0, c0, sm);
      heff::store_tile(acc, a.U + ((size_t)b * M * d + wt) * plane, chi, chi,
                       chi, r0, c0);
    }
  }
  grid.sync();

  // Enew_v = sum_s (sum_{w,t} W[w,v,s,t] U[w*d+t]) X_s
  for (int job = bid; job < a.B * M * sq; job += nb) {
    const int b = job / (M * sq), v = (job / sq) % M;
    int r0, c0;
    tile_origin(job % sq, r0, c0);
    const T* Xb = X + b * panel;
    const T* Ub = a.U + (size_t)b * M * d * plane;
    T acc[SUB][SUB];
    heff::zero_acc(acc);
    for (int s = 0; s < d; ++s) {
      heff::LoadQ<T> aload{Ub, sm.wc + (v * d + s) * (M * d), M * d, plane,
                           chi};
      heff::tile_gemm(acc, aload, Xb + s * plane, chi, chi, chi, chi, r0, c0,
                      sm);
    }
    heff::store_tile(acc, a.Enew + ((size_t)b * M + v) * plane, chi, chi, chi,
                     r0, c0);
  }
}

// One cooperative launch, every block resident: the grid is the kernel's
// occupancy times the SM count, capped at the largest job list of a stage
// (fewer blocks make each grid.sync() cheaper).  Writes the grid size to
// *grid_out; returns the launch's cudaError_t.
template <typename T>
int launch(Args<T> a, int* grid_out, cudaStream_t stream) {
  auto kern = gauge_env_kernel<T>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const int nt = heff::num_tiles(a.chi), sq = nt * nt;
  const int pt = ((a.d * a.chi + TILE - 1) / TILE) * nt;
  const long long panel = (long long)a.d * a.chi * a.chi;
  long long jobs = (long long)a.B * (sq + a.M * a.d * sq);
  if (jobs < (long long)a.B * pt) jobs = (long long)a.B * pt;
  if (jobs < (long long)a.B * ((panel + SEG - 1) / SEG))
    jobs = (long long)a.B * ((panel + SEG - 1) / SEG);
  int grid = per_sm * sms;
  if (jobs < grid) grid = (int)jobs;
  *grid_out = grid;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int run(const T* W, const T* E, const T* A, T* Q, T* P, T* Enew, T* X2, T* G,
        T* Mx, T* U, T* part, int B, int chi, int d, int M, int quintic,
        int cubic, int* grid, void* stream) {
  Args<T> a{W, E, A, Q, P, Enew, X2, G, Mx, U, part,
            B, chi, d, M, quintic, cubic};
  return launch<T>(a, grid, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// Route "resident": one block per instance, the panel in shared memory
// ---------------------------------------------------------------------------
namespace res {

using tc32::mma;
using tc32::split;

constexpr int THREADS = 256;     // 8 warps
constexpr int RED_BYTES = 272;   // 33 doubles of block sums, to 16 bytes
constexpr int GRAN = 32;         // chi is padded with zeros to CP = 32 k
constexpr int MAX_CP = 128;      // the largest instance (G G: 64 floats a
                                 // thread in registers)
constexpr size_t SMEM_LIMIT = 232448;  // one H100 block's shared memory

// The footprint of an instance at padded chi CP: X (d CP rows, pitch
// CP + 8), G (CP rows, pitch CP + 4), the couplings and the block sums.
// ops/kernels.py gauge_env_resident_bytes is the same formula.
inline size_t smem_bytes(int cp, int d, int M) {
  return RED_BYTES +
         4 * ((size_t)d * cp * (cp + 8) + (size_t)cp * (cp + 4) +
              (size_t)M * M * d * d);
}

template <int CP>
struct Shape {
  static constexpr int PX = CP + 8;  // = 8 (mod 32): k-major and paired reads
  static constexpr int PG = CP + 4;  // = 4 (mod 32): row reads, paired k
  // square products (CP x CP out): warps 2 x 4, SQ x SQ fragments each
  static constexpr int SQ = CP / 32;
  // the panel product X F: warps 4 x 2, PM x PN fragments each, row
  // blocks of RB rows (128 x 64 at CP=64: 32 floats a thread)
  static constexpr int PN = CP / 16;
  static constexpr int PM = CP == 64 ? 2 : 1;
  static constexpr int RB = 64 * PM;
  // two blocks an SM where the footprint allows it (128 registers)
  static constexpr int MIN_BLOCKS = CP <= 64 ? 2 : 1;
};

// How warp_mma reads its A operand A(r, k): by rows at S[r*pa + k]
// (A_ROW), by rows with the paired k order below (A_PAIR), or k-major at
// S[k*pa + r] (A_COL: the A^T of X^T Y).
enum { A_ROW = 0, A_PAIR = 1, A_COL = 2 };

// acc[i][j] += sum_{k < K} A(r0 + 16i + ., k) B(k, c0 + 8j + .) over the
// warp's MT x NT m16n8k8 fragments, B(k, c) = Bs[k*pb + c], in 3xTF32:
// each 8-deep step's small x big, big x small and big x big products are
// summed from zero and the sum is added to acc in f32.  With A_PAIR the
// step's fragment positions q and q+4 hold k = 2q and 2q+1, so that a row
// read of A is one 8-byte load; B's reads follow the same order.
// Fragments of rows >= rows are skipped (the test is uniform in a warp).
template <int MT, int NT, int AL>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const float* As, int pa,
                                         const float* Bs, int pb, int K,
                                         int r0, int c0, int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int kb0 = AL == A_PAIR ? 2 * q : q;
  const int kb1 = AL == A_PAIR ? 2 * q + 1 : q + 4;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* p = Bs + c0 + 8 * j + g;
      split(p[(k0 + kb0) * pb], bb[j][0], bs[j][0]);
      split(p[(k0 + kb1) * pb], bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = r0 + 16 * i;
      if (r >= rows) continue;
      float a[4];
      if constexpr (AL == A_COL) {
        const float* p = As + (k0 + q) * pa + r + g;
        a[0] = p[0];
        a[1] = p[8];
        a[2] = p[4 * pa];
        a[3] = p[4 * pa + 8];
      } else if constexpr (AL == A_PAIR) {
        const float2 lo =
            *reinterpret_cast<const float2*>(As + (r + g) * pa + k0 + 2 * q);
        const float2 hi = *reinterpret_cast<const float2*>(
            As + (r + g + 8) * pa + k0 + 2 * q);
        a[0] = lo.x;
        a[1] = hi.x;
        a[2] = lo.y;
        a[3] = hi.y;
      } else {
        const float* p = As + (r + g) * pa + k0 + q;
        a[0] = p[0];
        a[1] = p[8 * pa];
        a[2] = p[4];
        a[3] = p[8 * pa + 4];
      }
      uint32_t ab[4], asm_[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], ab[e], asm_[e]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float dd[4] = {0.f, 0.f, 0.f, 0.f};
        mma(dd, asm_, bb[j]);
        mma(dd, ab, bs[j]);
        mma(dd, ab, bb[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += dd[e];
      }
    }
  }
}

// f(r, c, value) for each accumulator of the warp's fragments at (r0, c0),
// rows >= rows skipped
template <int MT, int NT, typename F>
__device__ __forceinline__ void each_acc(const float (&acc)[MT][NT][4],
                                         int r0, int c0, int rows, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (r0 + 16 * i >= rows) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = r0 + 16 * i + g, c = c0 + 8 * j + 2 * q;
      f(r, c, acc[i][j][0]);
      f(r, c + 1, acc[i][j][1]);
      f(r + 8, c, acc[i][j][2]);
      f(r + 8, c + 1, acc[i][j][3]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// dst[a*PG + c] = src[a*chi + c] for a, c < chi, zero in the padding
template <int CP>
__device__ __forceinline__ void stage(float* dst, const float* src, int chi) {
  for (int e = threadIdx.x; e < CP * CP; e += THREADS) {
    const int a = e / CP, c = e % CP;
    dst[a * Shape<CP>::PG + c] =
        a < chi && c < chi ? src[(size_t)a * chi + c] : 0.f;
  }
}

template <int CP>
__global__ void __launch_bounds__(THREADS, Shape<CP>::MIN_BLOCKS)
    resident_kernel(const float* __restrict__ W, const float* __restrict__ E,
                    const float* __restrict__ A, float* __restrict__ Q,
                    float* __restrict__ P, float* __restrict__ Enew,
                    float* U, int chi, int d, int M, int quintic,
                    int cubic) {
  using S = Shape<CP>;
  constexpr int PX = S::PX, PG = S::PG, SQ = S::SQ;
  extern __shared__ float4 smem4[];
  double* red = reinterpret_cast<double*>(smem4);
  float* X = reinterpret_cast<float*>(smem4) + RED_BYTES / 4;
  float* G = X + d * CP * PX;
  float* wc = G + CP * PG;  // wc[(v*d+s)*(M*d) + w*d+t] = W[w][v][s][t]
  const int tid = threadIdx.x, warp = tid / 32;
  const int rows = d * CP;
  const size_t b = blockIdx.x, plane = (size_t)chi * chi;
  A += b * d * plane;
  Q += b * d * plane;
  E += b * M * plane;
  P += b * plane;
  Enew += b * M * plane;
  U += b * M * d * plane;
  const int md = M * d;
  for (int e = tid; e < md * md; e += THREADS) {
    const int t = e % d, s = (e / d) % d, v = (e / (d * d)) % M,
              w = e / (d * d * M);
    wc[(v * d + s) * md + w * d + t] = W[e];
  }
  // the warp's origin in a square product (2 x 4 warps) and in a row
  // block of X F (4 x 2 warps)
  const int sr = (warp / 4) * 16 * SQ, sc = (warp % 4) * 8 * SQ;
  const int pr = (warp / 2) * 16 * S::PM, pc = (warp % 2) * 8 * S::PN;

  // X_0 = A / (|A| 1.01 + 1e-30), zero in the padding; |A|^2 in f64
  double part = 0.0;
  for (int e = tid; e < rows * CP; e += THREADS) {
    const int r = e / CP, c = e % CP, s = r / CP, a = r % CP;
    const float v =
        a < chi && c < chi ? A[((size_t)s * chi + a) * chi + c] : 0.f;
    X[r * PX + c] = v;
    part += (double)v * (double)v;
  }
  const float nrm = (float)sqrt(heff::block_sum(part, red));
  const float inv = 1.f / (nrm * 1.01f + 1e-30f);
  for (int e = tid; e < rows * CP; e += THREADS)  // this thread's elements
    X[(e / CP) * PX + e % CP] *= inv;
  __syncthreads();

  const int steps = quintic + cubic;
  for (int j = 0; j < steps; ++j) {
    const bool quin = j < quintic;
    {  // G = X^T X, written as it is summed (nothing reads G meanwhile)
      float acc[SQ][SQ][4];
      zero(acc);
      warp_mma<SQ, SQ, A_COL>(acc, X, PX, X, PX, rows, sr, sc, CP);
      each_acc(acc, sr, sc, CP, [&](int r, int c, float v) {
        G[r * PG + c] = v;
      });
    }
    __syncthreads();
    if (quin) {  // Mx = b G + c G G over G
      float acc[SQ][SQ][4];
      zero(acc);
      warp_mma<SQ, SQ, A_ROW>(acc, G, PG, G, PG, CP, sr, sc, CP);
      __syncthreads();  // every read of G is done
      each_acc(acc, sr, sc, CP, [&](int r, int c, float v) {
        float* p = G + r * PG + c;
        *p = -4.7750f * *p + 2.0315f * v;
      });
      __syncthreads();
    }
    // quintic: X' = a X + X Mx;  cubic: X' = 1.5 X - 0.5 X G; in place,
    // a row block at a time
    const float alpha = quin ? 3.4445f : 1.5f, beta = quin ? 1.f : -0.5f;
    for (int rb = 0; rb < rows; rb += S::RB) {
      float acc[S::PM][S::PN][4];
      zero(acc);
      warp_mma<S::PM, S::PN, A_PAIR>(acc, X, PX, G, PG, CP, rb + pr, pc,
                                     rows);
      __syncthreads();  // every read of these rows of X is done
      each_acc(acc, rb + pr, pc, rows, [&](int r, int c, float v) {
        float* p = X + r * PX + c;
        *p = alpha * *p + beta * v;
      });
    }
    __syncthreads();
  }

  // Q = X
  for (int e = tid; e < rows * CP; e += THREADS) {
    const int r = e / CP, c = e % CP, s = r / CP, a = r % CP;
    if (a < chi && c < chi)
      Q[((size_t)s * chi + a) * chi + c] = X[r * PX + c];
  }
  float acc[SQ][SQ][4];
  // P = sum_s X_s^T A_s, A_s staged into G
  zero(acc);
  for (int s = 0; s < d; ++s) {
    stage<CP>(G, A + s * plane, chi);
    __syncthreads();
    warp_mma<SQ, SQ, A_COL>(acc, X + s * CP * PX, PX, G, PG, CP, sr, sc, CP);
    __syncthreads();  // G is free
  }
  each_acc(acc, sr, sc, CP, [&](int r, int c, float v) {
    if (r < chi && c < chi) P[(size_t)r * chi + c] = v;
  });
  // U[w*d+t] = X_t^T E_w, E_w staged into G
  for (int w = 0; w < M; ++w) {
    stage<CP>(G, E + w * plane, chi);
    __syncthreads();
    for (int t = 0; t < d; ++t) {
      zero(acc);
      warp_mma<SQ, SQ, A_COL>(acc, X + t * CP * PX, PX, G, PG, CP, sr, sc,
                              CP);
      float* u = U + (size_t)(w * d + t) * plane;
      each_acc(acc, sr, sc, CP, [&](int r, int c, float v) {
        if (r < chi && c < chi) u[(size_t)r * chi + c] = v;
      });
    }
    __syncthreads();  // G is free; U is visible to the block
  }
  // Enew_v = sum_s Q_vs X_s, Q_vs = sum_{w,t} W[w,v,s,t] U[w*d+t] folded
  // as it is staged into G
  for (int v = 0; v < M; ++v) {
    zero(acc);
    for (int s = 0; s < d; ++s) {
      const float* coef = wc + (v * d + s) * md;
      for (int e = tid; e < CP * CP; e += THREADS) {
        const int a = e / CP, c = e % CP;
        float qv = 0.f;
        if (a < chi && c < chi) {
          const size_t off = (size_t)a * chi + c;
          for (int i = 0; i < md; ++i) {
            const float cf = coef[i];
            if (cf != 0.f) qv += cf * U[i * plane + off];
          }
        }
        G[a * PG + c] = qv;
      }
      __syncthreads();
      warp_mma<SQ, SQ, A_ROW>(acc, G, PG, X + s * CP * PX, PX, CP, sr, sc,
                              CP);
      __syncthreads();  // G is free
    }
    float* out = Enew + v * plane;
    each_acc(acc, sr, sc, CP, [&](int r, int c, float x) {
      if (r < chi && c < chi) out[(size_t)r * chi + c] = x;
    });
  }
}

template <int CP>
int launch_cp(const float* W, const float* E, const float* A, float* Q,
              float* P, float* Enew, float* U, int B, int chi, int d, int M,
              int quintic, int cubic, cudaStream_t stream) {
  const size_t bytes = smem_bytes(CP, d, M);
  if (bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = resident_kernel<CP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, THREADS, bytes, stream>>>(W, E, A, Q, P, Enew, U, chi, d, M,
                                      quintic, cubic);
  return (int)cudaGetLastError();
}

// One block per instance at CP = chi rounded up to 32.  Writes B to *grid.
int launch(const float* W, const float* E, const float* A, float* Q,
           float* P, float* Enew, float* U, int B, int chi, int d, int M,
           int quintic, int cubic, int* grid, cudaStream_t stream) {
  const int cp = (chi + GRAN - 1) / GRAN * GRAN;
  if (B < 1 || chi < 1 || cp > MAX_CP || M * M * d * d > heff::MAX_COUPLINGS)
    return (int)cudaErrorInvalidValue;
  *grid = B;
  switch (cp) {
    case 32:
      return launch_cp<32>(W, E, A, Q, P, Enew, U, B, chi, d, M, quintic,
                           cubic, stream);
    case 64:
      return launch_cp<64>(W, E, A, Q, P, Enew, U, B, chi, d, M, quintic,
                           cubic, stream);
    case 96:
      return launch_cp<96>(W, E, A, Q, P, Enew, U, B, chi, d, M, quintic,
                           cubic, stream);
    case 128:
      return launch_cp<128>(W, E, A, Q, P, Enew, U, B, chi, d, M, quintic,
                            cubic, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace res

}  // namespace

// W: (M,M,d,d) shared by the batch; E: (B,M,chi,chi); A: (B,d*chi,chi);
// out Q: (B,d*chi,chi), P: (B,chi,chi), Enew: (B,M,chi,chi); scratch U:
// (B,M*d,chi,chi).  resident = 0: route "grid", with scratch X2:
// (B,d*chi,chi), G, Mx: (B,chi,chi), part: (B,nseg), nseg =
// ceil(d*chi*chi/4096) (SEG); resident = 1 (f32 only): route "resident",
// where X2, G, Mx and part are not read (null), chi <= 128 and
// res::smem_bytes fits one block.  *grid receives the blocks launched.
// Returns the launch's cudaError_t.
extern "C" int tn_fused_gauge_env_f32(const float* W, const float* E,
                                      const float* A, float* Q, float* P,
                                      float* Enew, float* X2, float* G,
                                      float* Mx, float* U, float* part, int B,
                                      int chi, int d, int M, int quintic,
                                      int cubic, int resident, int* grid,
                                      void* stream) {
  if (resident)
    return res::launch(W, E, A, Q, P, Enew, U, B, chi, d, M, quintic, cubic,
                       grid, (cudaStream_t)stream);
  return run<float>(W, E, A, Q, P, Enew, X2, G, Mx, U, part, B, chi, d, M,
                    quintic, cubic, grid, stream);
}

extern "C" int tn_fused_gauge_env_f64(const double* W, const double* E,
                                      const double* A, double* Q, double* P,
                                      double* Enew, double* X2, double* G,
                                      double* Mx, double* U, double* part,
                                      int B, int chi, int d, int M,
                                      int quintic, int cubic, int resident,
                                      int* grid, void* stream) {
  if (resident) return (int)cudaErrorInvalidValue;
  return run<double>(W, E, A, Q, P, Enew, X2, G, Mx, U, part, B, chi, d, M,
                     quintic, cubic, grid, stream);
}
