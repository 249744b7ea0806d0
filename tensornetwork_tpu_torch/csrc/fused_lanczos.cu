// Whole-Lanczos-step kernel: all m H_eff matvecs of one site's local
// eigensolve and the three-term recurrence, one block per instance.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_fused_lanczos (the
// function that reaches its pallas_call), at tile_b = 1.
//
// Semantics (kernels.py make_fused_lanczos, krylov.lanczos_factorization
// with reorthogonalize=False): v0 = x0/|x0| (zero and dead when
// |x0| <= delta); per step j: V[j] = v; w = H v; alpha = <v,w>;
// w -= alpha v + beta_prev v_prev; beta = |w|; a dead step stores the
// +1e10 alpha sentinel, a zero beta and a zero next vector.
//
// What bounds it on the H100: operations.  m matvecs of 4*M*d*chi^3 flops
// (63 MFLOP per instance at chi=64, M=3, d=2, m=10) against L, R, x in and
// V out, ~140 flops per byte in fp32; the fp32 SIMT rate (67 TFLOP/s)
// bounds it.
//
// Design: the TPU kernel keeps ~40 chi x chi tiles (~640 KB at chi=64) in
// VMEM; an H100 block has 227 KB of shared memory.  So the basis V is
// written straight to its output (v_j and v_{j-1} are read back from
// there), and the scratch P (M*d tiles) and w (d tiles) live in device
// memory, which at these sizes stays mostly in the 50 MB L2.  Only GEMM
// operand chunks and the couplings are staged through shared memory.  The
// batch rides the grid: one block per instance, no grid-wide
// synchronisation.  Block-wide reductions run in a fixed order.
#include "heff.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(heff::THREADS)
    fused_lanczos_kernel(const T* __restrict__ W, long long w_stride,
                         const T* __restrict__ Lt, const T* __restrict__ Rt,
                         const T* __restrict__ x0, T* __restrict__ V,
                         T* __restrict__ ab, T* __restrict__ Pbuf,
                         T* __restrict__ wbuf, int chi, int d, int M, int m,
                         T delta) {
  __shared__ heff::Smem<T> sm;
  const T LARGE = T(1e10);
  const size_t plane = (size_t)chi * chi;
  const size_t n = d * plane;
  const size_t b = blockIdx.x;
  const int nt = heff::num_tiles(chi);
  const int tid = threadIdx.x;

  Lt += b * M * plane;
  Rt += b * M * plane;
  x0 += b * n;
  V += b * (size_t)m * n;
  ab += b * 2 * m;
  T* P = Pbuf + b * M * d * plane;
  T* w = wbuf + b * n;
  heff::load_couplings(W + b * w_stride, d, M, sm);

  T part = T(0);
  for (size_t e = tid; e < n; e += blockDim.x) part += x0[e] * x0[e];
  const T nrm = sqrt(heff::block_sum(part, sm));
  bool alive = nrm > delta;
  T inv = alive ? T(1) / nrm : T(0);
  for (size_t e = tid; e < n; e += blockDim.x) V[e] = x0[e] * inv;
  T beta_prev = T(0);

  for (int j = 0; j < m; ++j) {
    __syncthreads();  // V[j] is complete
    const T* v = V + j * n;
    const T* vp = j > 0 ? V + (j - 1) * n : v;  // read only when j > 0
    for (int job = 0; job < M * d * nt * nt; ++job)
      heff::stage1_tile(job, Lt, v, P, chi, d, sm);
    __syncthreads();  // every P plane is complete
    for (int job = 0; job < d * nt * nt; ++job)
      heff::stage2_tile(job, Rt, P, w, chi, d, M, sm);
    __syncthreads();  // w = H v is complete

    part = T(0);
    for (size_t e = tid; e < n; e += blockDim.x) part += v[e] * w[e];
    const T alpha = heff::block_sum(part, sm);
    if (tid == 0) ab[j] = alive ? alpha : LARGE;

    // each thread updates, and later rescales, only its own elements
    part = T(0);
    for (size_t e = tid; e < n; e += blockDim.x) {
      T we = w[e] - alpha * v[e];
      if (j > 0) we -= beta_prev * vp[e];
      w[e] = we;
      part += we * we;
    }
    const T beta = sqrt(heff::block_sum(part, sm));
    const bool alive_next = alive && beta > delta;
    if (j < m - 1) {
      if (tid == 0) ab[m + j] = alive_next ? beta : T(0);
      inv = beta > delta ? T(1) / beta : T(0);
      const T keep = alive_next ? T(1) : T(0);
      T* vn = V + (j + 1) * n;
      for (size_t e = tid; e < n; e += blockDim.x) vn[e] = w[e] * inv * keep;
    }
    beta_prev = alive_next ? beta : T(0);
    alive = alive_next;
  }
  if (tid == 0) ab[m + m - 1] = T(0);
}

template <typename T>
int launch(const T* W, long long w_stride, const T* Lt, const T* Rt,
           const T* x0, T* V, T* ab, T* P, T* w, int B, int chi, int d,
           int M, int m, double delta, cudaStream_t stream) {
  fused_lanczos_kernel<T><<<B, heff::THREADS, 0, stream>>>(
      W, w_stride, Lt, Rt, x0, V, ab, P, w, chi, d, M, m, (T)delta);
  return (int)cudaGetLastError();
}

}  // namespace

// W: (M,M,d,d) shared (w_stride 0) or one per instance (w_stride M*M*d*d).
// Lt, Rt: (B,M,chi,chi); x0: (B,d,chi,chi); V: (B,m,d,chi,chi);
// ab: (B,2,m); scratch P: (B,M*d,chi,chi), w: (B,d,chi,chi).
// Returns cudaGetLastError() after the launch.
extern "C" int tn_fused_lanczos_f32(const float* W, long long w_stride,
                                    const float* Lt, const float* Rt,
                                    const float* x0, float* V, float* ab,
                                    float* P, float* w, int B, int chi,
                                    int d, int M, int m, double delta,
                                    void* stream) {
  return launch<float>(W, w_stride, Lt, Rt, x0, V, ab, P, w, B, chi, d, M, m,
                       delta, (cudaStream_t)stream);
}

extern "C" int tn_fused_lanczos_f64(const double* W, long long w_stride,
                                    const double* Lt, const double* Rt,
                                    const double* x0, double* V, double* ab,
                                    double* P, double* w, int B, int chi,
                                    int d, int M, int m, double delta,
                                    void* stream) {
  return launch<double>(W, w_stride, Lt, Rt, x0, V, ab, P, w, B, chi, d, M,
                        m, delta, (cudaStream_t)stream);
}
