// One batched one-site H_eff matvec, y = L.W.x.R, on kernel-layout operands.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_heff_matvec (the
// function that reaches its pallas_call).
//
// What bounds it on the H100: operations.  Per instance it does 2*M*d
// chi^3-GEMMs, 4*M*d*chi^3 flops (6.3 MFLOP at chi=64, M=3, d=2) against
// (2*M + 2*d)*chi^2 words in and out, ~38 flops per byte in fp32 -- above
// the card's ~20 flop/byte ridge for fp32 outside the tensor cores
// (67 TFLOP/s over 3.35 TB/s).
//
// Design: stage 1 spreads the M*d tiles of P_wt = Lt_w x_t of every
// instance over the grid and writes them to a scratch P in device memory
// (L2-resident at these sizes); stage 2 spreads the d output tiles of every
// instance over the grid, folding the couplings into the A operand as it
// is staged.  Two launches, because stage 2 needs all of an instance's P.
// The fused Lanczos kernel runs the same two device functions on one
// instance inside one block, where a __syncthreads() replaces the launch
// boundary.
#include "heff.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(heff::THREADS)
    heff_stage1_kernel(const T* __restrict__ Lt, const T* __restrict__ x,
                       T* __restrict__ P, int chi, int d, int M) {
  __shared__ heff::Smem<T> sm;
  const size_t plane = (size_t)chi * chi;
  const size_t b = blockIdx.y;
  heff::stage1_tile(blockIdx.x, Lt + b * M * plane, x + b * d * plane,
                    P + b * M * d * plane, chi, d, sm);
}

template <typename T>
__global__ void __launch_bounds__(heff::THREADS)
    heff_stage2_kernel(const T* __restrict__ W, long long w_stride,
                       const T* __restrict__ Rt, const T* __restrict__ P,
                       T* __restrict__ y, int chi, int d, int M) {
  __shared__ heff::Smem<T> sm;
  const size_t plane = (size_t)chi * chi;
  const size_t b = blockIdx.y;
  heff::load_couplings(W + b * w_stride, d, M, sm);
  heff::stage2_tile(blockIdx.x, Rt + b * M * plane, P + b * M * d * plane,
                    y + b * d * plane, chi, d, M, sm);
}

template <typename T>
int launch(const T* W, long long w_stride, const T* Lt, const T* Rt,
           const T* x, T* P, T* y, int B, int chi, int d, int M,
           cudaStream_t stream) {
  const int nt = heff::num_tiles(chi);
  heff_stage1_kernel<T><<<dim3(M * d * nt * nt, B), heff::THREADS, 0,
                          stream>>>(Lt, x, P, chi, d, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  heff_stage2_kernel<T><<<dim3(d * nt * nt, B), heff::THREADS, 0, stream>>>(
      W, w_stride, Rt, P, y, chi, d, M);
  return (int)cudaGetLastError();
}

}  // namespace

// W: (M,M,d,d) shared (w_stride 0) or one per instance (w_stride M*M*d*d).
// Lt, Rt: (B,M,chi,chi); x, y: (B,d,chi,chi); P: scratch (B,M*d,chi,chi).
// Returns cudaGetLastError() after the launches.
extern "C" int tn_heff_matvec_f32(const float* W, long long w_stride,
                                  const float* Lt, const float* Rt,
                                  const float* x, float* P, float* y, int B,
                                  int chi, int d, int M, void* stream) {
  return launch<float>(W, w_stride, Lt, Rt, x, P, y, B, chi, d, M,
                       (cudaStream_t)stream);
}

extern "C" int tn_heff_matvec_f64(const double* W, long long w_stride,
                                  const double* Lt, const double* Rt,
                                  const double* x, double* P, double* y,
                                  int B, int chi, int d, int M,
                                  void* stream) {
  return launch<double>(W, w_stride, Lt, Rt, x, P, y, B, chi, d, M,
                        (cudaStream_t)stream);
}
