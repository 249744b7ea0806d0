// One H_eff matvec with any number nt of physical tiles, returning
// y = L.C.x.R and alpha = <x, y>: the matvec of the chi=1024 one-site tier,
// whose three-term recurrence runs in PyTorch between calls.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_streamed_matvec (the
// function that reaches its pallas_call).
//
// Index conventions (kernel layout):
//   Lt[w][c][a]   C[w][v][s][t]   Rt[v][b][d]   x[t][a][b]  ->  y[s][c][d]
// Stage 1:  Q[v][s] = sum_{w,t} C[w,v,s,t] (Lt_w @ x_t)      M*nt GEMMs
// Stage 2:  y_s = sum_v Q[v][s] @ Rt_v                       M*nt GEMMs
//
// What bounds it on the H100: operations.  4*M*nt*chi^3 flops (26 GFLOP
// at chi=1024, M=3, nt=2) against (2M + 2nt)*chi^2 words in and out
// (42 MB), ~600 flops per byte in fp32.
//
// Design: the TPU kernel chunks both output axes over its grid and keeps
// the coupling-folded Q[v, s] of one row chunk in VMEM.  Here Q is
// M*nt planes of device-memory scratch: stage 1 spreads the 64x64 output
// tiles of all instances over the grid, and each block folds every
// L_w x_t tile product through the couplings into the Q tiles it owns
// (each thread reads and writes only its own outputs, so no barrier).
// Stage 2 is the pure tile GEMM over the (s, tile) outputs, and each tile
// writes its share of <x, y> to a fixed slot; a third launch sums the
// slots of each instance in a fixed order, so alpha is deterministic and
// no float atomics are used.  Three launches, because stage 2 needs all of
// an instance's Q, and alpha all of its y.  No tensor cores (heff.cuh).
#include "heff.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(heff::THREADS)
    fold_stage_kernel(const T* __restrict__ C, long long c_stride,
                      const T* __restrict__ Lt, const T* __restrict__ x,
                      T* __restrict__ Q, int chi, int nt, int M) {
  __shared__ heff::Smem<T> sm;
  const size_t plane = (size_t)chi * chi;
  const size_t b = blockIdx.y;
  const int ntl = heff::num_tiles(chi);
  const int r0 = (blockIdx.x / ntl) * heff::TILE;
  const int c0 = (blockIdx.x % ntl) * heff::TILE;
  const int ncoup = M * M * nt * nt;
  for (int e = threadIdx.x; e < ncoup; e += blockDim.x)
    sm.wc[e] = C[b * c_stride + e];
  __syncthreads();
  Lt += b * M * plane;
  x += b * nt * plane;
  Q += b * M * nt * plane;
  for (int w = 0; w < M; ++w)
    for (int t = 0; t < nt; ++t) {
      T acc[heff::SUB][heff::SUB];
      heff::zero_acc(acc);
      heff::LoadPlain<T> aload{Lt + w * plane, chi};
      heff::tile_gemm(acc, aload, x + t * plane, chi, chi, chi, chi, r0, c0,
                      sm);
      const bool first = w == 0 && t == 0;
      for (int v = 0; v < M; ++v)
        for (int s = 0; s < nt; ++s) {
          const T c = sm.wc[((w * M + v) * nt + s) * nt + t];
          if (first || c != T(0))  // uniform across the block
            heff::fold_tile(acc, c, Q + (v * nt + s) * plane, chi, r0, c0,
                            first);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(heff::THREADS)
    gemm_stage_kernel(const T* __restrict__ Q, const T* __restrict__ Rt,
                      const T* __restrict__ x, T* __restrict__ y,
                      T* __restrict__ part, int chi, int nt, int M) {
  __shared__ heff::Smem<T> sm;
  const size_t plane = (size_t)chi * chi;
  const size_t b = blockIdx.y;
  const int ntl = heff::num_tiles(chi);
  const int s = blockIdx.x / (ntl * ntl), tile = blockIdx.x % (ntl * ntl);
  const int r0 = (tile / ntl) * heff::TILE, c0 = (tile % ntl) * heff::TILE;
  Q += b * M * nt * plane;
  Rt += b * M * plane;
  T acc[heff::SUB][heff::SUB];
  heff::zero_acc(acc);
  for (int v = 0; v < M; ++v) {
    heff::LoadPlain<T> aload{Q + (v * nt + s) * plane, chi};
    heff::tile_gemm(acc, aload, Rt + v * plane, chi, chi, chi, chi, r0, c0,
                    sm);
  }
  const size_t off = (b * nt + s) * plane;
  heff::store_tile(acc, y + off, chi, chi, chi, r0, c0);
  T p = heff::tile_dot(acc, x + off, chi, chi, chi, r0, c0);
  p = heff::block_sum(p, sm);
  if (threadIdx.x == 0) part[b * gridDim.x + blockIdx.x] = p;
}

template <typename T>
int launch(const T* C, long long c_stride, const T* Lt, const T* Rt,
           const T* x, T* Q, T* y, T* part, T* alpha, int B, int chi,
           int nt, int M, cudaStream_t stream) {
  const int ntl = heff::num_tiles(chi);
  fold_stage_kernel<T><<<dim3(ntl * ntl, B), heff::THREADS, 0, stream>>>(
      C, c_stride, Lt, x, Q, chi, nt, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gemm_stage_kernel<T><<<dim3(nt * ntl * ntl, B), heff::THREADS, 0,
                         stream>>>(Q, Rt, x, y, part, chi, nt, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  heff::ordered_sum_kernel<T><<<B, heff::THREADS, 0, stream>>>(
      part, nt * ntl * ntl, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// C: (M,M,nt,nt) shared (c_stride 0) or one per instance (c_stride
// M*M*nt*nt).  Lt, Rt: (B,M,chi,chi); x, y: (B,nt,chi,chi); alpha: (B,);
// scratch Q: (B,M*nt,chi,chi), part: (B,nt*ntl*ntl) with ntl =
// ceil(chi/64).  Returns cudaGetLastError() after the launches.
extern "C" int tn_streamed_matvec_f32(const float* C, long long c_stride,
                                      const float* Lt, const float* Rt,
                                      const float* x, float* Q, float* y,
                                      float* part, float* alpha, int B,
                                      int chi, int nt, int M, void* stream) {
  return launch<float>(C, c_stride, Lt, Rt, x, Q, y, part, alpha, B, chi, nt,
                       M, (cudaStream_t)stream);
}

extern "C" int tn_streamed_matvec_f64(const double* C, long long c_stride,
                                      const double* Lt, const double* Rt,
                                      const double* x, double* Q, double* y,
                                      double* part, double* alpha, int B,
                                      int chi, int nt, int M, void* stream) {
  return launch<double>(C, c_stride, Lt, Rt, x, Q, y, part, alpha, B, chi,
                        nt, M, (cudaStream_t)stream);
}
