// Streamed whole-Lanczos kernel: all m matvecs and the three-term
// recurrence of one site, with the whole card on one instance.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_fused_lanczos_streamed
// (the function that reaches its pallas_call), the one-site chi=512 tier.
// It computes exactly make_fused_lanczos's function, as the TPU kernel
// does: the same (V, ab) from the same operands (fused_lanczos.cu).
//
// What bounds it on the H100: operations.  m matvecs of 4*M*d*chi^3 flops
// (32.2 GFLOP at chi=512, M=3, d=2, m=10) against L, R, x in and the basis
// out (~29 MB), ~1100 flops per byte in fp32.  Bounds at that shape: 0.195
// ms for fp32-accurate products by 3xTF32 on the tensor cores (3 x flops
// at 495 TFLOP/s), 0.481 ms on the fp32 SIMT core (67 TFLOP/s); bytes
// 0.009 ms.
//
// Design: the TPU kernel chunks chi over a sequential grid axis so that
// its working set fits VMEM and streams the basis out.  On the H100 the
// basis streams to device memory as in fused_lanczos.cu; the problem at a
// batch of one is that one block per instance leaves 131 SMs idle.  So
// this is one cooperative, persistent launch per site (lanczos_grid.cuh):
// in f32 every resident block walks tile jobs of each 3xTF32 tensor-core
// GEMM stage through its cp.async ring -- stage 1 one (M chi) x (d chi)
// GEMM, the coupling fold once per element, stage 2 split over v into 3
// slots: at chi=512 96 jobs a stage of 128x128 tiles, one block an SM
// (109 KB of shared memory; 1.90 ms against 2.26 at 64x64 tiles, two an
// SM, benchmarks/lgrid_breakdown.py on an H100 80GB HBM3 at 700 W) --
// grid-wide barriers (6 a step, ~1.3 us each) separate the stages and the
// recurrence passes, and the reductions across blocks sum fixed partial
// slots in a fixed order (f64 sums of f32 products).  f64 runs heff.cuh's
// SIMT tiles.
#include "lanczos_grid.cuh"

namespace {

template <typename T>
int run(const T* W, long long w_stride, const T* Lt, const T* Rt,
        const T* x0, T* V, T* ab, T* P, T* slots, double* apart,
        double* bpart, T* alive0, int B, int chi, int d, int M, int m,
        int tile, int S, double delta, int* grid, void* stream) {
  // no Ritz weights and no y: this mode emits the basis
  lgrid::Args<T> a{W, w_stride, Lt, Rt, x0, V, ab, nullptr, nullptr,
                   P, slots, apart, bpart, alive0, B, chi, d, M, m, tile,
                   S, (T)delta};
  return lgrid::launch<lgrid::BASIS>(a, grid, (cudaStream_t)stream);
}

}  // namespace

// W: (M,M,d,d) shared (w_stride 0) or one per instance (w_stride M*M*d*d).
// Lt, Rt: (B,M,chi,chi); x0: (B,d,chi,chi); V: (B,m,d,chi,chi);
// ab: (B,2,m); scratch P: (B,M*d*chi*chi), slots: (B,S,d,chi,chi),
// apart, bpart: (B,nseg) f64, alive0: (B,) with nseg = ceil(d*chi*chi /
// 1024).  tile, S: the plan (ops/kernels.py lgrid_plan; f64: S = 1, tile
// unused).  *grid receives the blocks launched.  Returns the launch's
// cudaError_t.
extern "C" int tn_fused_lanczos_streamed_f32(
    const float* W, long long w_stride, const float* Lt, const float* Rt,
    const float* x0, float* V, float* ab, float* P, float* slots,
    double* apart, double* bpart, float* alive0, int B, int chi, int d,
    int M, int m, int tile, int S, double delta, int* grid, void* stream) {
  return run<float>(W, w_stride, Lt, Rt, x0, V, ab, P, slots, apart, bpart,
                    alive0, B, chi, d, M, m, tile, S, delta, grid, stream);
}

extern "C" int tn_fused_lanczos_streamed_f64(
    const double* W, long long w_stride, const double* Lt, const double* Rt,
    const double* x0, double* V, double* ab, double* P, double* slots,
    double* apart, double* bpart, double* alive0, int B, int chi, int d,
    int M, int m, int tile, int S, double delta, int* grid, void* stream) {
  return run<double>(W, w_stride, Lt, Rt, x0, V, ab, P, slots, apart, bpart,
                     alive0, B, chi, d, M, m, tile, S, delta, grid, stream);
}
