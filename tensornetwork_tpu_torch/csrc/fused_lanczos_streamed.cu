// Streamed whole-Lanczos kernel: all m matvecs and the three-term
// recurrence of one site, with the whole card on one instance.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_fused_lanczos_streamed
// (the function that reaches its pallas_call), the one-site chi=512 tier.
// It computes exactly make_fused_lanczos's function, as the TPU kernel
// does: the same (V, ab) from the same operands (fused_lanczos.cu).
//
// What bounds it on the H100: operations.  m matvecs of 4*M*d*chi^3 flops
// (32 GFLOP at chi=512, M=3, d=2, m=10) against L, R, x in and the basis
// out (~29 MB), ~1100 flops per byte in fp32.
//
// Design: the TPU kernel chunks chi over a sequential grid axis so that
// its working set fits VMEM and streams the basis out.  On the H100 the
// basis streams to device memory as in fused_lanczos.cu; the problem at a
// batch of one is that one block per instance leaves 131 SMs idle.  So
// this is one cooperative, persistent launch per site (lanczos_grid.cuh):
// every resident block walks the 64x64 output tiles of each matvec stage,
// grid-wide barriers separate the stages and the recurrence, and the
// reductions across blocks sum fixed partial slots in a fixed order.
#include "lanczos_grid.cuh"

namespace {

template <typename T>
int run(const T* W, long long w_stride, const T* Lt, const T* Rt,
        const T* x0, T* V, T* ab, T* P, T* w, T* apart, T* bpart, T* alive0,
        int B, int chi, int d, int M, int m, double delta, int* grid,
        void* stream) {
  // no Ritz weights and no y: this mode emits the basis
  lgrid::Args<T> a{W, w_stride, Lt, Rt, x0, V, ab, nullptr, nullptr,
                   P, w, apart, bpart, alive0, B, chi, d, M, m, (T)delta};
  return lgrid::launch<T, lgrid::BASIS>(a, grid, (cudaStream_t)stream);
}

}  // namespace

// W: (M,M,d,d) shared (w_stride 0) or one per instance (w_stride M*M*d*d).
// Lt, Rt: (B,M,chi,chi); x0: (B,d,chi,chi); V: (B,m,d,chi,chi);
// ab: (B,2,m); scratch P: (B,M*d,chi,chi), w: (B,d,chi,chi),
// apart: (B,d*nt*nt), bpart: (B,nseg), alive0: (B,) with nt = ceil(chi/64)
// and nseg = ceil(d*chi*chi/4096).  *grid receives the blocks launched.
// Returns the launch's cudaError_t.
extern "C" int tn_fused_lanczos_streamed_f32(
    const float* W, long long w_stride, const float* Lt, const float* Rt,
    const float* x0, float* V, float* ab, float* P, float* w, float* apart,
    float* bpart, float* alive0, int B, int chi, int d, int M, int m,
    double delta, int* grid, void* stream) {
  return run<float>(W, w_stride, Lt, Rt, x0, V, ab, P, w, apart, bpart,
                    alive0, B, chi, d, M, m, delta, grid, stream);
}

extern "C" int tn_fused_lanczos_streamed_f64(
    const double* W, long long w_stride, const double* Lt, const double* Rt,
    const double* x0, double* V, double* ab, double* P, double* w,
    double* apart, double* bpart, double* alive0, int B, int chi, int d,
    int M, int m, double delta, int* grid, void* stream) {
  return run<double>(W, w_stride, Lt, Rt, x0, V, ab, P, w, apart, bpart,
                     alive0, B, chi, d, M, m, delta, grid, stream);
}
