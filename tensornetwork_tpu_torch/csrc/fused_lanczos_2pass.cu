// Two-pass Lanczos: the recurrence without storing the Krylov basis.
// Pass 1 (fact) emits only (alpha, beta); pass 2 (replay) reruns the same
// recurrence with pass 1's coefficients and accumulates the Ritz vector
// y = sum_j wts[j] v_j on the fly.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_fused_lanczos_2pass (the
// functions that reach its two pallas_calls, fact and replay), the
// one-site chi=384 tier.
//
// What bounds it on the H100: operations.  fact runs m matvecs, replay
// m-1, each 4*M*d*chi^3 flops (1.36 GFLOP at chi=384, M=3, d=2; 25.8 GFLOP
// the pair at m=10), against L, R, x in and ab or y out (~5-6 MB): 2000-3000
// flops per byte.  Bounds of the pair at chi=384, m=10: 0.156 ms for
// fp32-accurate products by 3xTF32 on the tensor cores (3 x flops at 495
// TFLOP/s), 0.385 ms on the fp32 SIMT core (67 TFLOP/s); bytes 0.002 ms.
//
// Design: the TPU kernel keeps the basis out of its 16 MB of VMEM at the
// price of twice the matvecs.  On the H100 the basis would fit device
// memory; the tier is kept so that both packages take the same path and
// the same arithmetic.  Both passes are the cooperative, persistent grid
// Lanczos of lanczos_grid.cuh with v_j and v_{j-1} in a two-slot ring: in
// f32 each matvec is two 3xTF32 tensor-core GEMM stages of tile jobs
// spread over every resident block, the coupling fold once per element
// between them, and stage 2 split over v into 3 slots.  At chi=384 the
// plan (ops/kernels.py lgrid_plan) takes 64x64 tiles, two 256-thread
// blocks an SM with 60 KB of shared memory each (the 55 KB cp.async ring,
// the couplings, the reduction slots): 216 jobs a stage.  The same m=10
// steps in the streamed kernel took 1.03 ms there against 1.45 at 128x128
// tiles, one block an SM (benchmarks/lgrid_breakdown.py on an H100 80GB
// HBM3 at 700 W).  f64
// runs heff.cuh's SIMT tiles.  All reductions are deterministic, so
// replay's v_j are the bits fact's recurrence produced, and fact's ab is
// the streamed kernel's (fused_lanczos_streamed.cu).  Barriers: fact 6 a
// step (stage 1 | fold | stage 2 | <v, w> | update, |w|^2 | v_next),
// replay 4 (its coefficients are inputs: one pass sums the slots,
// updates, adds wt v to y and writes v_next).
#include "lanczos_grid.cuh"

namespace {

template <typename T>
int fact(const T* W, long long w_stride, const T* Lt, const T* Rt,
         const T* x0, T* ring, T* ab, T* P, T* slots, double* apart,
         double* bpart, T* alive0, int B, int chi, int d, int M, int m,
         int tile, int S, double delta, int* grid, void* stream) {
  lgrid::Args<T> a{W, w_stride, Lt, Rt, x0, ring, ab, nullptr, nullptr,
                   P, slots, apart, bpart, alive0, B, chi, d, M, m, tile,
                   S, (T)delta};
  return lgrid::launch<lgrid::FACT>(a, grid, (cudaStream_t)stream);
}

template <typename T>
int replay(const T* W, long long w_stride, const T* Lt, const T* Rt,
           const T* x0, const T* wts, const T* ab, T* y, T* ring, T* P,
           T* slots, double* bpart, T* alive0, int B, int chi, int d, int M,
           int m, int tile, int S, double delta, int* grid, void* stream) {
  // ab is only read in this mode; replay needs no <v, w> partials
  lgrid::Args<T> a{W, w_stride, Lt, Rt, x0, ring, const_cast<T*>(ab), wts,
                   y, P, slots, nullptr, bpart, alive0, B, chi, d, M, m,
                   tile, S, (T)delta};
  return lgrid::launch<lgrid::REPLAY>(a, grid, (cudaStream_t)stream);
}

}  // namespace

// Shapes as in fused_lanczos_streamed.cu; ring: scratch (B,2,d,chi,chi).
// fact writes ab (B,2,m).  replay reads ab and wts (B,m) and writes
// y (B,d,chi,chi).  tile, S: the plan (ops/kernels.py lgrid_plan; f64:
// S = 1, tile unused).  *grid receives the blocks launched.  Each returns
// the launch's cudaError_t.
extern "C" int tn_fused_lanczos_fact_f32(
    const float* W, long long w_stride, const float* Lt, const float* Rt,
    const float* x0, float* ring, float* ab, float* P, float* slots,
    double* apart, double* bpart, float* alive0, int B, int chi, int d,
    int M, int m, int tile, int S, double delta, int* grid, void* stream) {
  return fact<float>(W, w_stride, Lt, Rt, x0, ring, ab, P, slots, apart,
                     bpart, alive0, B, chi, d, M, m, tile, S, delta, grid,
                     stream);
}

extern "C" int tn_fused_lanczos_fact_f64(
    const double* W, long long w_stride, const double* Lt, const double* Rt,
    const double* x0, double* ring, double* ab, double* P, double* slots,
    double* apart, double* bpart, double* alive0, int B, int chi, int d,
    int M, int m, int tile, int S, double delta, int* grid, void* stream) {
  return fact<double>(W, w_stride, Lt, Rt, x0, ring, ab, P, slots, apart,
                      bpart, alive0, B, chi, d, M, m, tile, S, delta, grid,
                      stream);
}

extern "C" int tn_fused_lanczos_replay_f32(
    const float* W, long long w_stride, const float* Lt, const float* Rt,
    const float* x0, const float* wts, const float* ab, float* y,
    float* ring, float* P, float* slots, double* bpart, float* alive0,
    int B, int chi, int d, int M, int m, int tile, int S, double delta,
    int* grid, void* stream) {
  return replay<float>(W, w_stride, Lt, Rt, x0, wts, ab, y, ring, P, slots,
                       bpart, alive0, B, chi, d, M, m, tile, S, delta, grid,
                       stream);
}

extern "C" int tn_fused_lanczos_replay_f64(
    const double* W, long long w_stride, const double* Lt, const double* Rt,
    const double* x0, const double* wts, const double* ab, double* y,
    double* ring, double* P, double* slots, double* bpart, double* alive0,
    int B, int chi, int d, int M, int m, int tile, int S, double delta,
    int* grid, void* stream) {
  return replay<double>(W, w_stride, Lt, Rt, x0, wts, ab, y, ring, P, slots,
                        bpart, alive0, B, chi, d, M, m, tile, S, delta, grid,
                        stream);
}
