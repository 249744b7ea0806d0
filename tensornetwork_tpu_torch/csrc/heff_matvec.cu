// One batched H_eff matvec, y = L.W.x.R, on kernel-layout operands, with
// any number nt of physical tiles (d one-site, d*d two-site with the
// fused MPO pair).
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_heff_matvec (the
// function that reaches its pallas_call).
//
// What bounds it on the H100: operations.  Per instance it does 2*M*nt
// chi^3-GEMMs, 4*M*nt*chi^3 flops (6.3 MFLOP at chi=64, M=3, nt=2)
// against (2*M + 2*nt)*chi^2 words in and out, ~38 flops per byte in
// fp32: above the card's ~20 flop/byte ridge for fp32 outside the tensor
// cores (67 TFLOP/s over 3.35 TB/s), and near the ~50 of 3xTF32 on them
// (3 TF32 products of 495 TFLOP/s per fp32 product).
//
// f32 runs on the 3xTF32 tensor-core core of gemm_tc32.cuh (fp32-accurate
// products; each 8-deep big x big product summed from zero and added in
// f32, stage_mma<FINE>, so that the tensor cores' round-toward-zero
// stays out of the outputs), route "tc32": the streamed matvec's three
// launches (K7's, streamed_matvec.cu, without <x, y>): stage 1 one
// (M chi) x (nt chi) GEMM per instance into P, the coupling fold P -> Q,
// stage 2 one chi x (M chi) GEMM per s, each grid of 64 x 64 tiles
// spread over the card (instance on blockIdx.y; at 128-row tiles the
// FINE sums spill).
// f64 runs the SIMT tile GEMM of heff.cuh in two launches (route
// "simt"): stage 1 spreads the M*nt tiles of P_wt = Lt_w x_t of every
// instance over the grid into a scratch P (L2-resident at these sizes);
// stage 2 spreads the nt output tiles of every instance over the grid,
// folding the couplings into the A operand as it is staged.  The f32
// instance of that kernel, the first port, is never routed: it is kept
// as the yardstick the redesign is timed against (kernels.py
// heff_matvec_simt).  No float atomics on either route: a repeat launch
// gives the same bits.
#include "gemm_tc32.cuh"
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
int launch_simt(const T* W, long long w_stride, const T* Lt, const T* Rt,
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

// Route "tc32": the three launches, stage 2 without <x, y>.
int launch_tc32(const float* W, long long w_stride, const float* Lt,
                const float* Rt, const float* x, float* P, float* Q, float* y,
                int B, int chi, int nt, int M, cudaStream_t stream) {
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = chi % 4 == 0 && tc32::aligned16(Lt) &&
                   tc32::aligned16(Rt) && tc32::aligned16(x) &&
                   tc32::aligned16(Q);
  cudaError_t err = tc32::launch_stage1<64, 64, true>(Lt, x, P, B, chi, nt,
                                                      M, 1, vec, stream);
  if (err != cudaSuccess) return (int)err;
  err = tc32::launch_fold(W, w_stride, P, Q, B, chi, nt, M, 1, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)tc32::launch_stage2<64, 64, true, false>(
      Q, Rt, nullptr, y, nullptr, B, chi, nt, M, vec, stream);
}

enum Route { SIMT = 0, TC32 = 1 };

}  // namespace

// W: (M,M,d,d) shared (w_stride 0) or one per instance (w_stride
// M*M*d*d); d is the number of physical tiles nt.  Lt, Rt: (B,M,chi,chi);
// x, y: (B,d,chi,chi); P, Q: scratch of B*M*d*chi^2 words each (Q read by
// route "tc32" only).  route: Route.  Returns the first launch error.
extern "C" int tn_heff_matvec_f32(const float* W, long long w_stride,
                                  const float* Lt, const float* Rt,
                                  const float* x, float* P, float* Q,
                                  float* y, int B, int chi, int d, int M,
                                  int route, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == SIMT)
    return launch_simt<float>(W, w_stride, Lt, Rt, x, P, y, B, chi, d, M, st);
  if (route != TC32 || M * d > tc32::MAX_MN) return (int)cudaErrorInvalidValue;
  return launch_tc32(W, w_stride, Lt, Rt, x, P, Q, y, B, chi, d, M, st);
}

// f64: the SIMT route only (route must be 0; Q is not read).
extern "C" int tn_heff_matvec_f64(const double* W, long long w_stride,
                                  const double* Lt, const double* Rt,
                                  const double* x, double* P, double* Q,
                                  double* y, int B, int chi, int d, int M,
                                  int route, void* stream) {
  (void)Q;
  if (route != SIMT) return (int)cudaErrorInvalidValue;
  return launch_simt<double>(W, w_stride, Lt, Rt, x, P, y, B, chi, d, M,
                             (cudaStream_t)stream);
}
