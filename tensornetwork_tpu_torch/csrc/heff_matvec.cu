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
// heff_matvec_simt).  No float atomics on any route: a repeat launch
// gives the same bits.
//
// The block contract (route "rect", either dtype): the bond-sharded sweep
// gives K1 this rank's block of the right bond, x (B,nt,chi,chib) and Rt
// (B,M,chib,chid), and wants the partial sum over that block, y
// (B,nt,chi,chid).  Three launches of a plain SIMT tile GEMM that takes
// any extents: stage 1 P[b,w,t] = Lt[b,w] @ x[b,t] (chi x chib), the
// coupling fold into Q[b,s][c][(v,bb)], stage 2 y[b,s] = Q[b,s] (chi x
// M chib) @ Rt[b] (M chib x chid).  64 x 64 output tiles, 16-deep steps
// through shared memory, a 4 x 4 register tile a thread.
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

// Route "rect": C[g] = A[g] (rows x K) @ B[g] (K x cols), row-major with
// leading dimensions lda, ldb, ldc, one (64 x 64 tile, g) a block.
constexpr int RT = 64, RK = 16, RTHREADS = 256;

template <typename T>
__device__ void rect_tile(const T* __restrict__ A, int lda,
                          const T* __restrict__ Bm, int ldb, T* __restrict__ C,
                          int ldc, int rows, int K, int cols) {
  __shared__ T As[RK][RT + 1];
  __shared__ T Bs[RK][RT];
  const int r0 = blockIdx.y * RT, c0 = blockIdx.x * RT;
  const int tr = (threadIdx.x / 16) * 4, tc = (threadIdx.x % 16) * 4;
  T acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += RK) {
    for (int e = threadIdx.x; e < RT * RK; e += RTHREADS) {
      const int r = e / RK, k = e % RK;
      As[k][r] = (r0 + r < rows && k0 + k < K)
                     ? A[(size_t)(r0 + r) * lda + k0 + k] : T(0);
      const int kb = e / RT, c = e % RT;
      Bs[kb][c] = (k0 + kb < K && c0 + c < cols)
                      ? Bm[(size_t)(k0 + kb) * ldb + c0 + c] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][tr + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tc + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r0 + tr + i < rows && c0 + tc + j < cols)
        C[(size_t)(r0 + tr + i) * ldc + c0 + tc + j] = acc[i][j];
}

// stage 1: g = (b*M + w)*nt + t
template <typename T>
__global__ void __launch_bounds__(RTHREADS)
    rect_stage1_kernel(const T* __restrict__ Lt, const T* __restrict__ x,
                       T* __restrict__ P, int chi, int chib, int nt, int M) {
  const size_t g = blockIdx.z, t = g % nt, bw = g / nt, b = bw / M;
  rect_tile<T>(Lt + bw * chi * chi, chi, x + (b * nt + t) * chi * chib, chib,
               P + g * chi * chib, chib, chi, chi, chib);
}

// the fold: one thread per (c, bb) of instance blockIdx.y;
// Q[b][s][c][v*chib + bb] = sum_{w,t} W[w,v,s,t] P[b][w][t][c][bb]
template <typename T>
__global__ void __launch_bounds__(RTHREADS)
    rect_fold_kernel(const T* __restrict__ W, long long w_stride,
                     const T* __restrict__ P, T* __restrict__ Q, int chi,
                     int chib, int nt, int M) {
  __shared__ T cs[heff::MAX_COUPLINGS];
  const size_t b = blockIdx.y;
  const int mn = M * nt;
  for (int e = threadIdx.x; e < mn * mn; e += blockDim.x)
    cs[e] = W[b * w_stride + e];  // W[w][v][s][t]
  __syncthreads();
  const size_t plane = (size_t)chi * chib;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= plane) return;
  const size_t c = e / chib, bb = e % chib;
  const T* p = P + b * mn * plane + e;
  T* q = Q + b * mn * plane + c * M * chib + bb;
  for (int s = 0; s < nt; ++s)
    for (int v = 0; v < M; ++v) {
      T sum = T(0);
      for (int w = 0; w < M; ++w)
        for (int t = 0; t < nt; ++t)
          sum += cs[((w * M + v) * nt + s) * nt + t] * p[(w * nt + t) * plane];
      q[(size_t)s * plane * M + v * chib] = sum;
    }
}

// stage 2: g = b*nt + s
template <typename T>
__global__ void __launch_bounds__(RTHREADS)
    rect_stage2_kernel(const T* __restrict__ Q, const T* __restrict__ Rt,
                       T* __restrict__ y, int chi, int chib, int chid, int nt,
                       int M) {
  const size_t g = blockIdx.z, b = g / nt;
  const int ldq = M * chib;
  rect_tile<T>(Q + g * chi * ldq, ldq, Rt + b * ldq * chid, chid,
               y + g * chi * chid, chid, chi, ldq, chid);
}

template <typename T>
int launch_rect(const T* W, long long w_stride, const T* Lt, const T* Rt,
                const T* x, T* P, T* Q, T* y, int B, int chi, int nt, int M,
                int chib, int chid, cudaStream_t stream) {
  if ((long long)B * M * nt > 65535 || B > 65535 || chib < 1 || chid < 1)
    return (int)cudaErrorInvalidValue;
  const int rb = (chi + RT - 1) / RT;
  rect_stage1_kernel<T><<<dim3((chib + RT - 1) / RT, rb, B * M * nt),
                          RTHREADS, 0, stream>>>(Lt, x, P, chi, chib, nt, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t plane = (size_t)chi * chib;
  rect_fold_kernel<T><<<dim3((unsigned)((plane + RTHREADS - 1) / RTHREADS),
                             B), RTHREADS, 0, stream>>>(W, w_stride, P, Q,
                                                        chi, chib, nt, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rect_stage2_kernel<T><<<dim3((chid + RT - 1) / RT, rb, B * nt), RTHREADS,
                          0, stream>>>(Q, Rt, y, chi, chib, chid, nt, M);
  return (int)cudaGetLastError();
}

enum Route { SIMT = 0, TC32 = 1, RECT = 2 };

}  // namespace

// W: (M,M,d,d) shared (w_stride 0) or one per instance (w_stride
// M*M*d*d); d is the number of physical tiles nt.  Lt: (B,M,chi,chi);
// Rt: (B,M,chib,chid); x: (B,d,chi,chib); y: (B,d,chi,chid); P, Q: scratch
// of B*M*d*chi*chib words each (Q read by routes "tc32" and "rect").
// Routes SIMT and TC32 take the square contract chib = chid = chi only;
// RECT takes any.  route: Route.  Returns the first launch error.
extern "C" int tn_heff_matvec_f32(const float* W, long long w_stride,
                                  const float* Lt, const float* Rt,
                                  const float* x, float* P, float* Q,
                                  float* y, int B, int chi, int d, int M,
                                  int chib, int chid, int route,
                                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == RECT)
    return launch_rect<float>(W, w_stride, Lt, Rt, x, P, Q, y, B, chi, d, M,
                              chib, chid, st);
  if (chib != chi || chid != chi) return (int)cudaErrorInvalidValue;
  if (route == SIMT)
    return launch_simt<float>(W, w_stride, Lt, Rt, x, P, y, B, chi, d, M, st);
  if (route != TC32 || M * d > tc32::MAX_MN) return (int)cudaErrorInvalidValue;
  return launch_tc32(W, w_stride, Lt, Rt, x, P, Q, y, B, chi, d, M, st);
}

// f64: the SIMT route, or RECT (Q is read by RECT only).
extern "C" int tn_heff_matvec_f64(const double* W, long long w_stride,
                                  const double* Lt, const double* Rt,
                                  const double* x, double* P, double* Q,
                                  double* y, int B, int chi, int d, int M,
                                  int chib, int chid, int route,
                                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == RECT)
    return launch_rect<double>(W, w_stride, Lt, Rt, x, P, Q, y, B, chi, d, M,
                               chib, chid, st);
  if (route != SIMT || chib != chi || chid != chi)
    return (int)cudaErrorInvalidValue;
  return launch_simt<double>(W, w_stride, Lt, Rt, x, P, y, B, chi, d, M, st);
}
