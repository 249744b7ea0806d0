// Chained-GEMM probe: P independent chains of
//   y = bf16(x @ b);  x = bf16(y @ c)      (f32 accumulation)
// repeated `reps` times on x (M,K), b (K,N), c (N,K), all bf16.
//
// Replaces: benchmarks/mxu_micro.py make_chain_kernel (the function that
// reaches its pallas_call), the TPU's matrix-unit issue-rate probe.  The
// H100 has no MXU: here it probes the issue rate and latency of dependent
// bf16 tensor-core GEMMs.
//
// What bounds it on the H100: operations, 4*M*K*N flops per chain and rep
// at the bf16 tensor-core peak (989 TFLOP/s); its operands are a few MB
// at most.  In practice the dependence between steps bounds it: a step
// starts when the previous one is complete, as on the TPU (P=1 measures
// the latency of one dependent GEMM).
//
// Design: row i of x @ b @ c depends on row i of x only, so a block owns a
// panel of 32 rows of one chain across all reps and needs no grid-wide
// synchronisation.  The panel x (32 x K) and the intermediate y (32 x N)
// stay in shared memory; b and c (at most 1 MB each) are read as fragments
// straight from device memory, where they stay in L2.  Eight warps split
// the 16x16 output fragments of each product and run warp-level
// tensor-core products (WMMA, bf16 fragments, f32 accumulators); each
// warp rounds its accumulator to bf16 through a 1 KB staging tile.  A
// __syncthreads() separates the dependent products.  No wgmma or TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 32;  // rows of one chain per block
constexpr int F = 16;   // fragment edge

__host__ __device__ inline size_t smem_bytes(int K, int N) {
  return (size_t)RB * (K + N) * sizeof(bf16) + (size_t)WARPS * F * F * 4;
}

// dst (RB x n, leading dimension n) = bf16(src (RB x k, shared) @ Bg (k x n,
// device memory)).  stage: this warp's 16x16 f32 tile.
__device__ void panel_product(const bf16* src, int k, const bf16* Bg, int n,
                              bf16* dst, float* stage) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int fcols = n / F, frags = (RB / F) * fcols;
  for (int f = warp; f < frags; f += WARPS) {
    const int fr = f / fcols, fc = f % fcols;
    wmma::fragment<wmma::accumulator, F, F, F, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < k; kk += F) {
      wmma::fragment<wmma::matrix_a, F, F, F, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, F, F, F, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(af, src + fr * F * k + kk, k);
      wmma::load_matrix_sync(bfr, Bg + (size_t)kk * n + fc * F, n);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(stage, acc, F, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < F * F; e += 32)
      dst[(fr * F + e / F) * n + fc * F + e % F] = __float2bfloat16_rn(stage[e]);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS)
    gemm_chain_kernel(const bf16* __restrict__ x, const bf16* __restrict__ b,
                      const bf16* __restrict__ c, bf16* __restrict__ out,
                      int M, int K, int N, int reps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // RB x K
  bf16* ys = xs + RB * K;                        // RB x N
  float* stage = reinterpret_cast<float*>(ys + RB * N) + (threadIdx.x / 32) * F * F;
  const int panels = M / RB;
  const size_t row0 = (size_t)(blockIdx.x / panels) * M + (blockIdx.x % panels) * RB;
  // RB*K bf16 = 4*K uint4 (K % 16 == 0); the panel is contiguous
  const int n16 = RB * K * (int)sizeof(bf16) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(x + row0 * K);
  for (int e = threadIdx.x; e < n16; e += THREADS)
    reinterpret_cast<uint4*>(xs)[e] = src[e];
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
    panel_product(xs, K, b, N, ys, stage);
    __syncthreads();
    panel_product(ys, N, c, K, xs, stage);
    __syncthreads();
  }
  uint4* dst = reinterpret_cast<uint4*>(out + row0 * K);
  for (int e = threadIdx.x; e < n16; e += THREADS)
    dst[e] = reinterpret_cast<const uint4*>(xs)[e];
}

}  // namespace

// x: (P,M,K), b: (K,N), c: (N,K), out: (P,M,K), all bf16 and contiguous;
// M % 32 == 0, K % 16 == 0, N % 16 == 0.  Returns cudaGetLastError() after
// the launch.
extern "C" int tn_gemm_chain_bf16(const void* x, const void* b, const void* c,
                                  void* out, int P, int M, int K, int N,
                                  int reps, void* stream) {
  if (M % RB || K % F || N % F || P < 1 || M < RB || reps < 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(K, N);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  gemm_chain_kernel<<<P * (M / RB), THREADS, bytes, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<bf16*>(out), M, K, N, reps);
  return (int)cudaGetLastError();
}
