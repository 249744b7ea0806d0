// One H_eff matvec with any number nt of physical tiles, returning
// y = L.C.x.R and alpha = <x, y>, with the contraction of stage 1 split
// into K3 chunks: the matvec of the XL tier (two-site chi=1024, nt=4;
// one-site chi=2048, nt=2), whose three-term recurrence runs in PyTorch
// between calls.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_streamed_matvec_xl (the
// function that reaches its two pallas_calls).
//
// Index conventions (kernel layout):
//   Lt[w][c][a]   C[w][v][s][t]   Rt[v][b][d]   x[t][a][b]  ->  y[s][c][d]
// Kernel A:  Qp[k3][v][s] = sum_{w,t} C[w,v,s,t] (Lt_w[:, a in k3] @
//            x_t[a in k3, :])                          M*nt GEMMs per chunk
// Kernel B:  y_s = sum_v (sum_k3 Qp[k3][v][s]) @ Rt_v  M*nt GEMMs
//
// What bounds it on the H100: operations.  4*M*nt*chi^3 flops (51.5 GFLOP
// at two-site chi=1024, M=3, nt=4; 206 GFLOP at one-site chi=2048, nt=2)
// against (2M + 2nt)*chi^2 words in and out (59 MB; 201 MB), ~900 flops per
// byte in fp32.
//
// Design: the TPU kernel exists because x alone (16 MB at two-site
// chi=1024) does not fit VMEM, so kernel A streams x in contraction chunks
// and revisits one Q block across them, in grid order.  On the card blocks
// run in no order, so each chunk k3 folds into its own partial slot
// Qp[k3] (M*nt*K3 planes of device-memory scratch): the block for (output
// tile, k3, instance) forms L_w x_t over its chunk for every (w, t) and
// folds each product through the couplings into the Qp[k3] tiles it owns
// (each thread reads and writes only its own outputs: no atomics, no
// barrier).  Kernel B, the pure GEMM epilogue, sums the K3 partials in a
// fixed order (0, 1, ..., K3-1) while it stages its A operand, writes y and
// one <x, y> share per tile to a fixed slot; a third launch sums the slots
// of each instance in a fixed order (heff::ordered_sum_kernel), so alpha is
// deterministic.  K3 multiplies kernel A's grid, which fills the card at a
// batch of one.  Partial slots are read through plain pointers.  No tensor
// cores (heff.cuh).  Strides are size_t: at chi=2048, M*nt*K3*chi^2 words
// exceed 2^31.
#include "heff.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(heff::THREADS)
    chunk_fold_kernel(const T* __restrict__ C, long long c_stride,
                      const T* __restrict__ Lt, const T* __restrict__ x,
                      T* Qp, int chi, int nt, int M, int K3) {
  __shared__ heff::Smem<T> sm;
  const size_t plane = (size_t)chi * chi;
  const size_t b = blockIdx.y;
  const int ntl = heff::num_tiles(chi);
  const int k3 = blockIdx.x % K3, tile = blockIdx.x / K3;
  const int r0 = (tile / ntl) * heff::TILE, c0 = (tile % ntl) * heff::TILE;
  const int ac = chi / K3, a0 = k3 * ac;  // this block's contraction chunk
  const int ncoup = M * M * nt * nt;
  for (int e = threadIdx.x; e < ncoup; e += blockDim.x)
    sm.wc[e] = C[b * c_stride + e];
  __syncthreads();
  Lt += b * M * plane;
  x += b * nt * plane;
  T* Q = Qp + (b * K3 + k3) * (size_t)(M * nt) * plane;
  for (int w = 0; w < M; ++w)
    for (int t = 0; t < nt; ++t) {
      T acc[heff::SUB][heff::SUB];
      heff::zero_acc(acc);
      heff::LoadPlain<T> aload{Lt + w * plane + a0, chi};
      heff::tile_gemm(acc, aload, x + t * plane + (size_t)a0 * chi, chi, ac,
                      chi, chi, r0, c0, sm);
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

// A operand of kernel B: Q_vs[r][k] = the K3 partial slots summed in order.
template <typename T>
struct LoadQsum {
  const T* Q;     // slot 0 of plane (v, s)
  size_t stride;  // between slots: M*nt*chi*chi
  int K3, ld;
  __device__ T operator()(int r, int k) const {
    const size_t off = (size_t)r * ld + k;
    T q = Q[off];
    for (int i = 1; i < K3; ++i) q += Q[i * stride + off];
    return q;
  }
};

template <typename T>
__global__ void __launch_bounds__(heff::THREADS)
    qsum_gemm_kernel(const T* Qp, const T* __restrict__ Rt,
                     const T* __restrict__ x, T* __restrict__ y,
                     T* __restrict__ part, int chi, int nt, int M, int K3) {
  __shared__ heff::Smem<T> sm;
  const size_t plane = (size_t)chi * chi;
  const size_t b = blockIdx.y;
  const int ntl = heff::num_tiles(chi);
  const int s = blockIdx.x / (ntl * ntl), tile = blockIdx.x % (ntl * ntl);
  const int r0 = (tile / ntl) * heff::TILE, c0 = (tile % ntl) * heff::TILE;
  const size_t slot = (size_t)(M * nt) * plane;
  Qp += b * K3 * slot;
  Rt += b * M * plane;
  T acc[heff::SUB][heff::SUB];
  heff::zero_acc(acc);
  for (int v = 0; v < M; ++v) {
    LoadQsum<T> aload{Qp + (v * nt + s) * plane, slot, K3, chi};
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
           const T* x, T* Qp, T* y, T* part, T* alpha, int B, int chi,
           int nt, int M, int K3, cudaStream_t stream) {
  if (K3 < 1 || chi % K3) return (int)cudaErrorInvalidValue;
  const int ntl = heff::num_tiles(chi);
  chunk_fold_kernel<T><<<dim3(ntl * ntl * K3, B), heff::THREADS, 0,
                         stream>>>(C, c_stride, Lt, x, Qp, chi, nt, M, K3);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qsum_gemm_kernel<T><<<dim3(nt * ntl * ntl, B), heff::THREADS, 0,
                        stream>>>(Qp, Rt, x, y, part, chi, nt, M, K3);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  heff::ordered_sum_kernel<T><<<B, heff::THREADS, 0, stream>>>(
      part, nt * ntl * ntl, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// C: (M,M,nt,nt) shared (c_stride 0) or one per instance (c_stride
// M*M*nt*nt).  Lt, Rt: (B,M,chi,chi); x, y: (B,nt,chi,chi); alpha: (B,);
// scratch Qp: (B,K3,M*nt,chi,chi), part: (B,nt*ntl*ntl) with ntl =
// ceil(chi/64).  K3 divides chi.  Returns cudaGetLastError() after the
// launches.
extern "C" int tn_streamed_matvec_xl_f32(const float* C, long long c_stride,
                                         const float* Lt, const float* Rt,
                                         const float* x, float* Qp, float* y,
                                         float* part, float* alpha, int B,
                                         int chi, int nt, int M, int K3,
                                         void* stream) {
  return launch<float>(C, c_stride, Lt, Rt, x, Qp, y, part, alpha, B, chi,
                       nt, M, K3, (cudaStream_t)stream);
}

extern "C" int tn_streamed_matvec_xl_f64(const double* C, long long c_stride,
                                         const double* Lt, const double* Rt,
                                         const double* x, double* Qp,
                                         double* y, double* part,
                                         double* alpha, int B, int chi,
                                         int nt, int M, int K3,
                                         void* stream) {
  return launch<double>(C, c_stride, Lt, Rt, x, Qp, y, part, alpha, B, chi,
                        nt, M, K3, (cudaStream_t)stream);
}
