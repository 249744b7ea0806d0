// One H_eff matvec with any number nt of physical tiles, returning
// y = L.C.x.R and alpha = <x, y>: the matvec of the chi=1024 one-site tier
// and of the two-site chi=128...512 tier, whose three-term recurrence runs
// in PyTorch between calls.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_streamed_matvec (the
// function that reaches its pallas_call).
//
// Index conventions (kernel layout):
//   Lt[w][c][a]   C[w][v][s][t]   Rt[v][b][d]   x[t][a][b]  ->  y[s][c][d]
//
// What bounds it on the H100: operations.  4*M*nt*chi^3 flops (26 GFLOP
// at one-site chi=1024, M=3, nt=2; 6.4 GFLOP at two-site chi=512, nt=4)
// against (2M + 2nt)*chi^2 words in and out (42 MB; 13 MB), ~600 and ~500
// flops per byte in fp32: above the card's ridge for fp32 outside the
// tensor cores (67 TFLOP/s, 20 flops per byte) and for 3xTF32 on them
// (3 x 989/2 TFLOP/s of TF32 work per fp32 flop, ~50 flops per byte).
//
// f32 design (gemm_tc32.cuh): two large GEMMs and a fold.  Stage 1 is one
// (M chi) x (nt chi) GEMM per instance, P = Lt @ [x_0 ... x_nt-1]; the
// fold pass applies the couplings with one thread per (c, b), reading the
// M*nt P values and writing the M*nt Q values of its element once (2 M nt
// chi^2 words, ~100 MB at two-site chi=1024, against ~1.2 GB for folding
// each tile product into every Q tile it feeds); stage 2 is one chi x (M chi)
// GEMM per s, y_s = [Q_0s ... Q_(M-1)s] @ Rt, whose tiles write their
// share of <x, y> to fixed slots, summed in order by a fourth launch.
// Both GEMMs run on the tensor cores in 3xTF32 (fp32-accurate), their
// operands streamed through a 3-stage cp.async ring, their tile picked on
// the host so that each grid covers the card (ops/kernels.py
// tc32_tile).  No float atomics: a second launch gives the same bits.
//
// f64: the SIMT tile GEMM of heff.cuh, as before (3xTF32 is f32 only; no
// f64 matvec is on a timed path): stage 1 spreads the 64x64 output tiles
// of all instances over the grid, and each block folds every L_w x_t tile
// product through the couplings into the Q tiles it owns (each thread
// reads and writes only its own outputs, so no barrier); stage 2 is the
// pure tile GEMM over the (s, tile) outputs with the same fixed-slot
// <x, y>.  The dtype picks the design; nothing f32 reaches the SIMT
// kernels.
#include "gemm_tc32.cuh"
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
// M*M*nt*nt).  Lt, Rt: (B,M,chi,chi); x, y: (B,nt,chi,chi); alpha: (B,).
// f32 scratch: P (B, M*chi, nt*chi), Q (B, nt, chi, M*chi), part (B,
// stage-2 blocks of tile2); tile1, tile2: the tile of each GEMM stage
// (tc32::TileCode).  f64 scratch: Q (B, M*nt, chi, chi), part (B,
// nt*ntl*ntl) with ntl = ceil(chi/64); P, tile1 and tile2 are not read.
// Returns the first launch error.
extern "C" int tn_streamed_matvec_f32(const float* C, long long c_stride,
                                      const float* Lt, const float* Rt,
                                      const float* x, float* P, float* Q,
                                      float* y, float* part, float* alpha,
                                      int B, int chi, int nt, int M,
                                      int tile1, int tile2, void* stream) {
  return tc32::launch_matvec(C, c_stride, Lt, Rt, x, P, Q, y, part, alpha, B,
                             chi, nt, M, 1, tile1, tile2,
                             (cudaStream_t)stream);
}

extern "C" int tn_streamed_matvec_f64(const double* C, long long c_stride,
                                      const double* Lt, const double* Rt,
                                      const double* x, double* P, double* Q,
                                      double* y, double* part, double* alpha,
                                      int B, int chi, int nt, int M,
                                      int tile1, int tile2, void* stream) {
  (void)P, (void)tile1, (void)tile2;
  return launch<double>(C, c_stride, Lt, Rt, x, Q, y, part, alpha, B, chi,
                        nt, M, (cudaStream_t)stream);
}
