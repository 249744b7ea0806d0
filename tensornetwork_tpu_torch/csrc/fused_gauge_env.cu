// Fused site epilogue of the one-site sweep: the Newton-Schulz polar gauge
// of the (d*chi, chi) panel and the environment growth, one cooperative
// launch for the whole batch.
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
// against ~0.2 MB in and out; fp32 SIMT (67 TFLOP/s) bounds it.  What
// limits it in practice is the chain of 21 dependent steps, each a few
// small GEMMs.
//
// Design: the TPU kernel keeps the panel and its iterates in VMEM, one
// grid program per instance.  On the H100 the panel alone is 128 KB at
// chi=128 and 512 KB at chi=256, past the 227 KB of shared memory, so the
// iterates live in device memory (mostly L2), ping-ponging between Q and a
// scratch panel so that the last one lands in Q; only GEMM operand chunks
// and the couplings are staged through shared memory.  One cooperative
// launch runs every step of every instance: the blocks walk the 64x64
// output tiles of each stage over the whole batch, with grid.sync()
// between dependent stages (3 per quintic step, 2 per cubic).  At B=256,
// chi=64 that spreads the batch over the card; at B=1, chi=256 it splits
// each GEMM of the one instance over 16-32 blocks.  The transposed
// operands of X^T Y are staged k-major, so neighbouring threads read
// neighbouring addresses.  The couplings are folded into the A operand of
// Enew while it is staged (heff::LoadQ, as in K1's stage 2).  The norm is
// summed from fixed partial slots in a fixed order: no float atomics.  No
// tensor cores (see heff.cuh).
#include <cooperative_groups.h>

#include "heff.cuh"

namespace {

namespace cg = cooperative_groups;
using heff::KC;
using heff::SUB;
using heff::THREADS;
using heff::TILE;

constexpr int SEG = THREADS * 16;  // elements per norm-partial job

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

}  // namespace

// W: (M,M,d,d) shared by the batch; E: (B,M,chi,chi); A: (B,d*chi,chi);
// out Q: (B,d*chi,chi), P: (B,chi,chi), Enew: (B,M,chi,chi); scratch X2:
// (B,d*chi,chi), G, Mx: (B,chi,chi), U: (B,M*d,chi,chi), part: (B,nseg)
// with nseg = ceil(d*chi*chi/4096).  *grid receives the blocks launched.
// Returns the launch's cudaError_t.
extern "C" int tn_fused_gauge_env_f32(const float* W, const float* E,
                                      const float* A, float* Q, float* P,
                                      float* Enew, float* X2, float* G,
                                      float* Mx, float* U, float* part, int B,
                                      int chi, int d, int M, int quintic,
                                      int cubic, int* grid, void* stream) {
  return run<float>(W, E, A, Q, P, Enew, X2, G, Mx, U, part, B, chi, d, M,
                    quintic, cubic, grid, stream);
}

extern "C" int tn_fused_gauge_env_f64(const double* W, const double* E,
                                      const double* A, double* Q, double* P,
                                      double* Enew, double* X2, double* G,
                                      double* Mx, double* U, double* part,
                                      int B, int chi, int d, int M,
                                      int quintic, int cubic, int* grid,
                                      void* stream) {
  return run<double>(W, E, A, Q, P, Enew, X2, G, Mx, U, part, B, chi, d, M,
                     quintic, cubic, grid, stream);
}
