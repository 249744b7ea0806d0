// Device code shared by the H_eff matvec kernel (heff_matvec.cu), the fused
// epilogue (fused_gauge_env.cu) and the f64 instances of the fused Lanczos
// kernel (fused_lanczos.cu), the grid-wide Lanczos kernels
// (lanczos_grid.cuh) and the streamed matvecs (streamed_matvec.cu,
// streamed_matvec_xl.cu); their f32 instances run on gemm_tc32.cuh.
//
// Index conventions (kernel layout, see ops/kernels.py prepare_operands):
//   Lt[w][c][a]   W[w][v][s][t]   Rt[v][b][d]   x[t][a][b]   ->  y[s][c][d]
// Stage 1:  P[w*d+t] = Lt_w @ x_t                       (M*d chi x chi GEMMs)
// Stage 2:  y_s = sum_v (sum_{w,t} W[w,v,s,t] P[w*d+t]) @ Rt_v
//           the couplings are folded into the A operand while it is staged
//           through shared memory, so Q_vs never exists as a tensor.
//
// Operands that a kernel may write while it runs (the Krylov vectors, the
// scratch P) are read through plain pointers, never `const __restrict__`,
// so that the compiler does not route them through the non-coherent
// read-only cache.
//
// Both stages are built from one fp32/fp64 SIMT tile GEMM: a 64x64 output
// tile per 256-thread block, 4x4 outputs per thread, the contraction staged
// through shared memory in chunks of 32.  No tensor cores: the solver needs
// true fp32 products (TF32 keeps ~3 decimal digits and breaks the
// variational bound of the Lanczos projection); gemm_tc32.cuh gets them
// from the tensor cores by 3xTF32.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace heff {

constexpr int TILE = 64;      // output tile edge
constexpr int KC = 32;        // contraction chunk staged per step
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int SUB = 4;        // each thread owns SUB x SUB outputs
constexpr int MAX_COUPLINGS = 1024;  // M*M*d*d held in shared memory

template <typename T>
struct Smem {
  T a[KC][TILE + 4];  // A chunk, stored contraction-major (padded)
  T b[KC][TILE];      // B chunk
  T red[33];          // block reductions
  T wc[MAX_COUPLINGS];  // couplings regrouped as wc[v][s][w*d+t]
};

__host__ __device__ inline int num_tiles(int chi) {
  return (chi + TILE - 1) / TILE;
}

// A operand of stage 1: a plain row-major chi x chi matrix.
template <typename T>
struct LoadPlain {
  const T* A;
  int ld;
  __device__ T operator()(int r, int k) const { return A[(size_t)r * ld + k]; }
};

// A operand of stage 2: Q_vs[c][b] = sum_i coef[i] * P[i][c][b],
// i = w*d+t.  Zero couplings (most of a sparse MPO) are skipped; the branch
// is uniform across the block.
template <typename T>
struct LoadQ {
  const T* P;
  const T* coef;  // shared memory, n entries
  int n;
  size_t plane;   // chi*chi
  int ld;
  __device__ T operator()(int r, int k) const {
    const size_t off = (size_t)r * ld + k;
    T q = T(0);
    for (int i = 0; i < n; ++i) {
      const T c = coef[i];
      if (c != T(0)) q += c * P[i * plane + off];
    }
    return q;
  }
};

// acc += A[r0:r0+64, :K] @ B[:K, c0:c0+64] with A read through `aload`
// and B row-major (leading dimension ldb).  Rows >= n_rows, columns >=
// n_cols and contraction indices >= K are masked to zero.  Ends with a
// __syncthreads(), so the caller may reuse the shared buffers at once.
template <typename T, typename ALoad>
__device__ void tile_gemm(T (&acc)[SUB][SUB], const ALoad& aload,
                          const T* Bm, int ldb, int K,
                          int n_rows, int n_cols, int r0, int c0,
                          Smem<T>& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int e = tid; e < TILE * KC; e += THREADS) {
      const int r = e / KC, k = e % KC;
      const int gr = r0 + r, gk = k0 + k;
      sm.a[k][r] = (gr < n_rows && gk < K) ? aload(gr, gk) : T(0);
    }
    for (int e = tid; e < KC * TILE; e += THREADS) {
      const int k = e / TILE, c = e % TILE;
      const int gk = k0 + k, gc = c0 + c;
      sm.b[k][c] = (gk < K && gc < n_cols) ? Bm[(size_t)gk * ldb + gc] : T(0);
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

template <typename T>
__device__ void zero_acc(T (&acc)[SUB][SUB]) {
#pragma unroll
  for (int i = 0; i < SUB; ++i)
#pragma unroll
    for (int j = 0; j < SUB; ++j) acc[i][j] = T(0);
}

template <typename T>
__device__ void store_tile(const T (&acc)[SUB][SUB], T* __restrict__ C,
                           int ld, int n_rows, int n_cols, int r0, int c0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < n_cols) C[(size_t)r * ld + c] = acc[i][j];
    }
  }
}

// Regroup W[w][v][s][t] into sm.wc[(v*d+s)*(M*d) + w*d+t] so that the
// couplings of one (v, s) are contiguous.  Ends with a __syncthreads().
template <typename T>
__device__ void load_couplings(const T* __restrict__ W, int d, int M,
                               Smem<T>& sm) {
  const int n = M * M * d * d;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int t = e % d, s = (e / d) % d, v = (e / (d * d)) % M,
              w = e / (d * d * M);
    sm.wc[(v * d + s) * (M * d) + w * d + t] = W[e];
  }
  __syncthreads();
}

// One output tile of stage 1.  job in [0, M*d*nt*nt).
template <typename T>
__device__ void stage1_tile(int job, const T* Lt, const T* x, T* P, int chi,
                            int d, Smem<T>& sm) {
  const int nt = num_tiles(chi);
  const int wt = job / (nt * nt), tile = job % (nt * nt);
  const int w = wt / d, t = wt % d;
  const size_t plane = (size_t)chi * chi;
  const int r0 = (tile / nt) * TILE, c0 = (tile % nt) * TILE;
  T acc[SUB][SUB];
  zero_acc(acc);
  LoadPlain<T> aload{Lt + w * plane, chi};
  tile_gemm(acc, aload, x + t * plane, chi, chi, chi, chi, r0, c0, sm);
  store_tile(acc, P + wt * plane, chi, chi, chi, r0, c0);
}

// This thread's share of <X, tile> over the outputs it owns (masked).
template <typename T>
__device__ T tile_dot(const T (&acc)[SUB][SUB], const T* X, int ld,
                      int n_rows, int n_cols, int r0, int c0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T part = T(0);
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < n_cols) part += X[(size_t)r * ld + c] * acc[i][j];
    }
  }
  return part;
}

// One output tile of stage 2.  job in [0, d*nt*nt).  Needs the couplings
// in sm.wc (load_couplings) and every P plane of the instance complete.
template <typename T>
__device__ void stage2_tile(int job, const T* Rt, const T* P, T* y, int chi,
                            int d, int M, Smem<T>& sm) {
  const int nt = num_tiles(chi);
  const int s = job / (nt * nt), tile = job % (nt * nt);
  const size_t plane = (size_t)chi * chi;
  const int r0 = (tile / nt) * TILE, c0 = (tile % nt) * TILE;
  T acc[SUB][SUB];
  zero_acc(acc);
  for (int v = 0; v < M; ++v) {
    LoadQ<T> aload{P, sm.wc + (v * d + s) * (M * d), M * d, plane, chi};
    tile_gemm(acc, aload, Rt + v * plane, chi, chi, chi, chi, r0, c0, sm);
  }
  store_tile(acc, y + s * plane, chi, chi, chi, r0, c0);
}

template <typename T>
__device__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block through red[0:33] in shared memory; every thread gets
// the result.  Fixed order, so the result does not change from run to run.
template <typename T>
__device__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    T s = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

template <typename T>
__device__ T block_sum(T v, Smem<T>& sm) {
  return block_sum(v, sm.red);
}

// Q_tile (+)= c * acc over this thread's outputs (masked); `first`
// overwrites.  Each thread reads and writes only its own outputs, so the
// callers need no barrier around it.
template <typename T>
__device__ void fold_tile(const T (&acc)[SUB][SUB], T c, T* Q, int chi,
                          int r0, int c0, bool first) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= chi) continue;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col >= chi) continue;
      T* q = Q + (size_t)r * chi + col;
      *q = first ? c * acc[i][j] : *q + c * acc[i][j];
    }
  }
}

// sum of p[0:n] in a fixed order (thread i takes i, i+256, ..., then the
// fixed block tree); every block gets the same bits
template <typename T>
__device__ T ordered_sum(const T* p, int n, T* red) {
  T s = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += p[i];
  return block_sum(s, red);
}

template <typename T>
__device__ T ordered_sum(const T* p, int n, Smem<T>& sm) {
  return ordered_sum(p, n, sm.red);
}

// out[b] = the n slots part[b*n ... b*n+n-1] summed in a fixed order, one
// block per instance: the last launch of the streamed matvecs, which turns
// the per-tile <x, y> shares into alpha without float atomics.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ordered_sum_kernel(const T* part, int n, T* out) {
  __shared__ Smem<T> sm;
  const T s = ordered_sum(part + (size_t)blockIdx.x * n, n, sm);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

}  // namespace heff
