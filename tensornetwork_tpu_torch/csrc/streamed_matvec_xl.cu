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
//
// What bounds it on the H100: operations.  4*M*nt*chi^3 flops (51.5 GFLOP
// at two-site chi=1024, M=3, nt=4; 206 GFLOP at one-site chi=2048, nt=2)
// against (2M + 2nt)*chi^2 words in and out (59 MB; 201 MB), ~900 flops per
// byte in fp32: far above the ridge of fp32 outside the tensor cores and
// of 3xTF32 on them.
//
// The TPU kernel exists because x alone (16 MB at two-site chi=1024) does
// not fit VMEM, so it streams x in contraction chunks and revisits one Q
// block across them, in grid order.  On the card blocks run in no order,
// so each chunk k3 writes its own partial slot, and the slots are summed
// in a fixed order (0, 1, ..., K3-1), so a second launch gives the same
// bits without float atomics.
//
// f32 design (gemm_tc32.cuh): streamed_matvec.cu's two tensor-core GEMMs
// (3xTF32 on a 3-stage cp.async ring) and fold, with stage 1 run as
// split-K: the block for (tile, k3, instance) contracts its chunk into the
// P slot k3 (B*K3*M*nt*chi^2 words of scratch), and the fold pass sums
// the K3 slots of each element in order before it applies the couplings:
// each slot is read once, by the bandwidth-bound fold.  K3 only adds
// blocks to stage 1; ops/kernels.py xl_chunk_count picks 1 where stage 1
// at 128x128 tiles already gives two blocks per SM -- both path shapes --
// and there the function is streamed_matvec.cu's.
//
// f64: the SIMT tile GEMM of heff.cuh, as before (3xTF32 is f32 only; no
// f64 matvec is on a timed path): kernel A folds each chunk's products
// into its own partial slot Qp[k3] (each thread reads and writes only its
// own outputs), kernel B sums the K3 partials in order while it stages its
// A operand and writes y and one <x, y> share per tile; a third launch
// sums the shares in order.  The dtype picks the design; nothing f32
// reaches the SIMT kernels.  Strides are size_t: at chi=2048,
// M*nt*K3*chi^2 words exceed 2^31.
#include "gemm_tc32.cuh"
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
// M*M*nt*nt).  Lt, Rt: (B,M,chi,chi); x, y: (B,nt,chi,chi); alpha: (B,).
// K3 divides chi.  f32 scratch: P (B, K3, M*chi, nt*chi), Q (B, nt, chi,
// M*chi), part (B, stage-2 blocks of tile2); tile1, tile2: the tile of
// each GEMM stage (tc32::TileCode).  f64 scratch: P holds the partial
// slots Qp (B, K3, M*nt, chi, chi), part (B, nt*ntl*ntl) with ntl =
// ceil(chi/64); Q, tile1 and tile2 are not read.  Returns the first
// launch error.
extern "C" int tn_streamed_matvec_xl_f32(const float* C, long long c_stride,
                                         const float* Lt, const float* Rt,
                                         const float* x, float* P, float* Q,
                                         float* y, float* part, float* alpha,
                                         int B, int chi, int nt, int M,
                                         int K3, int tile1, int tile2,
                                         void* stream) {
  return tc32::launch_matvec(C, c_stride, Lt, Rt, x, P, Q, y, part, alpha, B,
                             chi, nt, M, K3, tile1, tile2,
                             (cudaStream_t)stream);
}

extern "C" int tn_streamed_matvec_xl_f64(const double* C, long long c_stride,
                                         const double* Lt, const double* Rt,
                                         const double* x, double* P,
                                         double* Q, double* y, double* part,
                                         double* alpha, int B, int chi,
                                         int nt, int M, int K3, int tile1,
                                         int tile2, void* stream) {
  (void)Q, (void)tile1, (void)tile2;
  return launch<double>(C, c_stride, Lt, Rt, x, P, y, part, alpha, B, chi,
                        nt, M, K3, (cudaStream_t)stream);
}
