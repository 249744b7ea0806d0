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
// m-1, each 4*M*d*chi^3 flops (1.4 GFLOP at chi=384, M=3, d=2), against
// L, R, x in and ab or y out (~5-6 MB): 2000-3000 flops per byte in fp32.
//
// Design: the TPU kernel keeps the basis out of its 16 MB of VMEM at the
// price of twice the matvecs.  On the H100 the basis would fit device
// memory; the tier is kept so that both packages take the same path and
// the same arithmetic.  Both passes are the cooperative, persistent grid
// Lanczos of lanczos_grid.cuh with v_j and v_{j-1} in a two-slot ring:
// every block works on every step, and all reductions are deterministic,
// so replay's v_j are the bits fact's recurrence produced.  Replay needs
// no reduction at all (its coefficients are inputs): 3 grid barriers a
// step against fact's 4.
#include "lanczos_grid.cuh"

namespace {

template <typename T>
int fact(const T* W, long long w_stride, const T* Lt, const T* Rt,
         const T* x0, T* ring, T* ab, T* P, T* w, T* apart, T* bpart,
         T* alive0, int B, int chi, int d, int M, int m, double delta,
         int* grid, void* stream) {
  lgrid::Args<T> a{W, w_stride, Lt, Rt, x0, ring, ab, nullptr, nullptr,
                   P, w, apart, bpart, alive0, B, chi, d, M, m, (T)delta};
  return lgrid::launch<T, lgrid::FACT>(a, grid, (cudaStream_t)stream);
}

template <typename T>
int replay(const T* W, long long w_stride, const T* Lt, const T* Rt,
           const T* x0, const T* wts, const T* ab, T* y, T* ring, T* P,
           T* w, T* bpart, T* alive0, int B, int chi, int d, int M, int m,
           double delta, int* grid, void* stream) {
  // ab is only read in this mode; replay needs no <v, w> partials
  lgrid::Args<T> a{W, w_stride, Lt, Rt, x0, ring, const_cast<T*>(ab), wts,
                   y, P, w, nullptr, bpart, alive0, B, chi, d, M, m,
                   (T)delta};
  return lgrid::launch<T, lgrid::REPLAY>(a, grid, (cudaStream_t)stream);
}

}  // namespace

// Shapes as in fused_lanczos_streamed.cu; ring: scratch (B,2,d,chi,chi).
// fact writes ab (B,2,m).  replay reads ab and wts (B,m) and writes
// y (B,d,chi,chi).  *grid receives the blocks launched.  Each returns the
// launch's cudaError_t.
extern "C" int tn_fused_lanczos_fact_f32(
    const float* W, long long w_stride, const float* Lt, const float* Rt,
    const float* x0, float* ring, float* ab, float* P, float* w,
    float* apart, float* bpart, float* alive0, int B, int chi, int d, int M,
    int m, double delta, int* grid, void* stream) {
  return fact<float>(W, w_stride, Lt, Rt, x0, ring, ab, P, w, apart, bpart,
                     alive0, B, chi, d, M, m, delta, grid, stream);
}

extern "C" int tn_fused_lanczos_fact_f64(
    const double* W, long long w_stride, const double* Lt, const double* Rt,
    const double* x0, double* ring, double* ab, double* P, double* w,
    double* apart, double* bpart, double* alive0, int B, int chi, int d,
    int M, int m, double delta, int* grid, void* stream) {
  return fact<double>(W, w_stride, Lt, Rt, x0, ring, ab, P, w, apart, bpart,
                      alive0, B, chi, d, M, m, delta, grid, stream);
}

extern "C" int tn_fused_lanczos_replay_f32(
    const float* W, long long w_stride, const float* Lt, const float* Rt,
    const float* x0, const float* wts, const float* ab, float* y,
    float* ring, float* P, float* w, float* bpart, float* alive0, int B,
    int chi, int d, int M, int m, double delta, int* grid, void* stream) {
  return replay<float>(W, w_stride, Lt, Rt, x0, wts, ab, y, ring, P, w,
                       bpart, alive0, B, chi, d, M, m, delta, grid, stream);
}

extern "C" int tn_fused_lanczos_replay_f64(
    const double* W, long long w_stride, const double* Lt, const double* Rt,
    const double* x0, const double* wts, const double* ab, double* y,
    double* ring, double* P, double* w, double* bpart, double* alive0,
    int B, int chi, int d, int M, int m, double delta, int* grid,
    void* stream) {
  return replay<double>(W, w_stride, Lt, Rt, x0, wts, ab, y, ring, P, w,
                        bpart, alive0, B, chi, d, M, m, delta, grid, stream);
}
