// Batched MPS transfer chain: for each instance
//   E <- sum_{a,c,s} E[a,c] A_n[a,s,b] A_n[c,s,p]
// over all N sites, one launch, one block per instance, E resident in
// shared memory from the first site to the last.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_transfer_chain (the
// function that reaches its pallas_call); one function for its "loop",
// "rows" and "dg" variants, which differ only in the TPU program's layout.
//
// Rounding points (kernels.py make_transfer_chain): E is carried in f32;
// at every site it is cast to the input type T before stage 1,
//   Y_s[c,b] = sum_a T(E)[a,c] A_n[a,s,b]     (f32 sums, Y cast to T)
//   E'[b,p]  = sum_{s,c} Y_s[c,b] A_n[c,s,p]  (f32 sums)
// and E_N is returned in f32.  T is __nv_bfloat16 or float.
//
// What bounds it on the H100: at the bench shape (B=256, N=32, chi=128,
// d=2, bf16) each application reads 537 MB of site tensors and does 137
// GFLOP: 0.16 ms of device memory against 0.14 ms of bf16 tensor-core
// work, so bytes.  This first kernel is SIMT fp32 on widened operands (a
// bf16 x bf16 product is exact in f32, so it computes the function of the
// tensor-core version up to summation order), and the fp32 SIMT rate
// (67 TFLOP/s, 2.05 ms per application) bounds it instead.
//
// Design: the TPU kernel keeps E in VMEM across the sequential site axis
// of its grid and streams the site tensors.  Here a block owns one
// instance and walks its N sites in a loop: T(E) (chi^2), the site tensor
// (d*chi^2, copied from device memory once, 16 bytes a thread, in its
// solver layout [a][s][b]) and Y (d*chi^2) sit in shared memory (160 KB
// at chi=128 in bf16), so E never leaves the SM between sites.  Both
// stages read their operands k-major straight from shared memory: 256
// threads each own an 8x8 register tile of the chi x chi output (chi <=
// 128), rows ty+16i, columns tx+16j.  Only the last site writes E, in f32,
// to device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int SUB = 8;        // 8 x 8 outputs per thread
constexpr int MAX_CHI = 16 * SUB;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// shared-memory bytes of one block: T(E), the site tensor and Y
__host__ __device__ inline size_t smem_bytes(int chi, int d, size_t elem) {
  return (size_t)(1 + 2 * d) * chi * chi * elem;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    transfer_chain_kernel(const T* __restrict__ As, const float* __restrict__ E0,
                          float* __restrict__ out, int N, int chi, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sE = reinterpret_cast<T*>(smem_raw);  // T(E) [a][c]
  T* sA = sE + chi * chi;                  // A_n [a][s][b]
  T* sY = sA + d * chi * chi;              // Y [s][c][b]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int dchi = d * chi;
  const size_t site = (size_t)d * chi * chi;
  const size_t b = blockIdx.x;
  As += b * N * site;

  // clamped output indices: rows and columns >= chi compute on a copy of
  // the last one and are never stored
  int ri[SUB], ci[SUB];
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    ri[i] = min(ty + 16 * i, chi - 1);
    ci[i] = min(tx + 16 * i, chi - 1);
  }

  for (int e = tid; e < chi * chi; e += THREADS)
    sE[e] = from_f<T>(E0[b * chi * chi + e]);

  // 16-byte copies where the site tensors and sA are 16-byte aligned
  const bool vec = (site * sizeof(T)) % 16 == 0 &&
                   ((size_t)chi * chi * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(As) % 16) == 0;
  for (int n = 0; n < N; ++n) {
    const T* An = As + n * site;
    if (vec) {
      const uint4* src = reinterpret_cast<const uint4*>(An);
      uint4* dst = reinterpret_cast<uint4*>(sA);
      const int n16 = (int)(site * sizeof(T) / 16);
      for (int e = tid; e < n16; e += THREADS) dst[e] = src[e];
    } else {
      for (int e = tid; e < (int)site; e += THREADS) sA[e] = An[e];
    }
    __syncthreads();  // A_n staged; T(E) complete

    // stage 1: Y_s[c][b] = sum_a E[a][c] A_s[a][b]
    for (int s = 0; s < d; ++s) {
      float acc[SUB][SUB] = {};
      for (int k = 0; k < chi; ++k) {
        const T* er = sE + k * chi;
        const T* ar = sA + k * dchi + s * chi;
        float av[SUB], bv[SUB];
#pragma unroll
        for (int i = 0; i < SUB; ++i) av[i] = to_f(er[ri[i]]);
#pragma unroll
        for (int j = 0; j < SUB; ++j) bv[j] = to_f(ar[ci[j]]);
#pragma unroll
        for (int i = 0; i < SUB; ++i)
#pragma unroll
          for (int j = 0; j < SUB; ++j) acc[i][j] += av[i] * bv[j];
      }
      T* Ys = sY + s * chi * chi;
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          const int c = tx + 16 * j;
          if (r < chi && c < chi) Ys[r * chi + c] = from_f<T>(acc[i][j]);
        }
      }
    }
    __syncthreads();  // Y complete; nobody reads T(E) until the next site

    // stage 2: E'[b][p] = sum_s sum_c Y_s[c][b] A_s[c][p]
    float acc[SUB][SUB] = {};
    for (int s = 0; s < d; ++s) {
      const T* Ys = sY + s * chi * chi;
      for (int k = 0; k < chi; ++k) {
        const T* yr = Ys + k * chi;
        const T* ar = sA + k * dchi + s * chi;
        float av[SUB], bv[SUB];
#pragma unroll
        for (int i = 0; i < SUB; ++i) av[i] = to_f(yr[ri[i]]);
#pragma unroll
        for (int j = 0; j < SUB; ++j) bv[j] = to_f(ar[ci[j]]);
#pragma unroll
        for (int i = 0; i < SUB; ++i)
#pragma unroll
          for (int j = 0; j < SUB; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    const bool last = n == N - 1;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const int c = tx + 16 * j;
        if (r >= chi || c >= chi) continue;
        if (last)
          out[b * chi * chi + r * chi + c] = acc[i][j];
        else
          sE[r * chi + c] = from_f<T>(acc[i][j]);
      }
    }
    __syncthreads();  // stage 2 done with A_n and Y before the next site
  }
}

template <typename T>
int launch(const T* As, const float* E0, float* out, int B, int N, int chi,
           int d, cudaStream_t stream) {
  if (chi > MAX_CHI || chi < 1 || N < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(chi, d, sizeof(T));
  auto kern = transfer_chain_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, THREADS, bytes, stream>>>(As, E0, out, N, chi, d);
  return (int)cudaGetLastError();
}

}  // namespace

// As: (B,N,chi,d,chi) in the input type (the solver layout); E0: (B,chi,chi)
// f32; out: (B,chi,chi) f32.  chi <= 128 and (1+2d) chi^2 elements of
// shared memory.  Returns cudaGetLastError() after the launch.
extern "C" int tn_transfer_chain_bf16(const void* As, const float* E0,
                                      float* out, int B, int N, int chi, int d,
                                      void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(As), E0, out,
                               B, N, chi, d, (cudaStream_t)stream);
}

extern "C" int tn_transfer_chain_f32(const void* As, const float* E0,
                                     float* out, int B, int N, int chi, int d,
                                     void* stream) {
  return launch<float>(static_cast<const float*>(As), E0, out, B, N, chi, d,
                       (cudaStream_t)stream);
}
