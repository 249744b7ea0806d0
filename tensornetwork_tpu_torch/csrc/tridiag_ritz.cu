// K10: the power Ritz step of batched tridiagonal projections.  For each
// instance, the smallest Ritz pair of the m x m real symmetric tridiagonal
// T = tridiag(beta, alpha, beta) by steepest descent with a closed-form
// 2 x 2 Ritz step, started from e1:
//   Tw = T w, lam = w.Tw, r = Tw - lam w, r -= (w.r) w, rn = |r|,
//   u = r / rn, Tu = T u, h = w.Tu, g = u.Tu,
//   disc = sqrt(max((lam - g)^2 / 4 + h^2, 0)), mu = (lam + g) / 2 - disc,
//   v = h w + (mu - lam) u, vn = |v|, w <- v / vn
// (rn, vn replaced by 1 where they are not above 1e-30), keeping w where
// rn <= 1e-14 or vn <= 1e-30 (a converged w whose residual is rounding
// noise can give v = 0); after the iterations lam = w.(T w).
//
// Replaces: no TPU kernel.  In the JAX package this step is a lax.scan
// that XLA fuses around the Pallas Lanczos (ops/krylov.py tridiag_ritz).  The
// port ran it as ~42 eager PyTorch operations an iteration on (B, m)
// tensors, 2,500 launches a local solve that kept the card idle while the
// host dispatched them.  Here the whole loop is one launch.
//
// Arithmetic: in the input type (float or double), step for step the
// plain loop's (krylov.tridiag_ritz_power_plain): every product, sum,
// quotient and square root rounded where the loop rounds it (the _rn
// intrinsics keep the compiler from contracting or approximating them),
// thresholds compared in the input type.  Only the order of the sums
// differs: T u reads the three
// nonzero terms of a row, left to right, where the loop multiplies by a
// dense T, and a dot product is a butterfly over the warp.  Dead Lanczos
// steps (alpha = 1e10, beta = 0) and zero betas pass through as they are:
// w is exactly 0 past a zero beta, so those rows contribute exact zeros.
//
// Layout: one warp an instance, lane j holding entries j and j + 32, so m
// <= 64.  T u takes each entry's neighbours from the lanes beside it by
// __shfl_sync, the 31/32 seam crossing between the lane's two slots; a dot
// product is a __shfl_xor_sync butterfly, after which every lane holds the
// same bits (each step adds the same two partial sums in both lanes), so
// every lane takes the same branch.  WARPS instances a block, one block
// per WARPS instances.  Nothing is staged in shared memory: a lane keeps
// its six coefficients and its entries of w, r, u, v in registers.
//
// What bounds it on the H100: neither operations (~30 m flops an
// iteration) nor bytes (3 m values read, m + 1 written an instance), but
// the dependent chain of each iteration: five reductions of five shuffle
// steps, two matvecs, two square roots and two divisions in sequence, 60
// times.  Instances run side by side, one warp each: B = 4096 is 4,096
// warps, one wave on 132 SMs.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // instances (warps) a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float quo(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double quo(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
template <typename T>
__device__ __forceinline__ T sub(T a, T b) {
  return add(a, -b);
}

// sum over the warp of x0*y0 + x1*y1, the same bits in every lane
template <typename T>
__device__ __forceinline__ T dot(T x0, T x1, T y0, T y1) {
  T s = add(mul(x0, y0), mul(x1, y1));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = add(s, __shfl_xor_sync(FULL, s, o));
  return s;
}

// a lane's rows i = lane and lane + 32 of T: beta[i-1], alpha[i], beta[i],
// zero outside the m x m matrix
template <typename T>
struct Rows {
  T lo0, d0, hi0, lo1, d1, hi1;
};

// (T u) at this lane's entries
template <typename T>
__device__ __forceinline__ void tmv(const Rows<T>& t, T u0, T u1, int lane,
                                    T& y0, T& y1) {
  const int prev = (lane + 31) & 31, next = (lane + 1) & 31;
  const T p0 = __shfl_sync(FULL, u0, prev), p1 = __shfl_sync(FULL, u1, prev);
  const T n0 = __shfl_sync(FULL, u0, next), n1 = __shfl_sync(FULL, u1, next);
  // u[i - 1] and u[i + 1]: lane 0's second slot follows lane 31's first,
  // lane 31's first is followed by lane 0's second
  const T um0 = lane > 0 ? p0 : T(0), um1 = lane > 0 ? p1 : p0;
  const T up0 = lane < 31 ? n0 : n1, up1 = lane < 31 ? n1 : T(0);
  y0 = add(add(mul(t.lo0, um0), mul(t.d0, u0)), mul(t.hi0, up0));
  y1 = add(add(mul(t.lo1, um1), mul(t.d1, u1)), mul(t.hi1, up1));
}

template <typename T>
__device__ __forceinline__ T row_at(const T* p, int i, int n) {
  return (i >= 0 && i < n) ? p[i] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    ritz_kernel(const T* __restrict__ alphas, long long sa,
                const T* __restrict__ betas, long long sb, T* __restrict__ lam,
                T* __restrict__ w, int B, int m, int iters) {
  const int lane = threadIdx.x & 31;
  const long long inst = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (inst >= B) return;  // the whole warp leaves together
  const T* a = alphas + inst * sa;
  const T* b = betas + inst * sb;
  const int i0 = lane, i1 = lane + 32;
  Rows<T> t;
  t.lo0 = row_at(b, i0 - 1, m - 1);
  t.d0 = row_at(a, i0, m);
  t.hi0 = row_at(b, i0, m - 1);
  t.lo1 = row_at(b, i1 - 1, m - 1);
  t.d1 = row_at(a, i1, m);
  t.hi1 = row_at(b, i1, m - 1);

  const T tiny = T(1e-30), small = T(1e-14);
  T w0 = lane == 0 ? T(1) : T(0), w1 = T(0);
  for (int it = 0; it < iters; ++it) {
    T tw0, tw1;
    tmv(t, w0, w1, lane, tw0, tw1);
    const T l = dot(w0, w1, tw0, tw1);
    T r0 = sub(tw0, mul(l, w0)), r1 = sub(tw1, mul(l, w1));
    const T wr = dot(w0, w1, r0, r1);
    r0 = sub(r0, mul(wr, w0));
    r1 = sub(r1, mul(wr, w1));
    const T rn = root(dot(r0, r1, r0, r1));
    const T rs = rn > tiny ? rn : T(1);
    const T u0 = quo(r0, rs), u1 = quo(r1, rs);
    T tu0, tu1;
    tmv(t, u0, u1, lane, tu0, tu1);
    const T h = dot(w0, w1, tu0, tu1);
    const T g = dot(u0, u1, tu0, tu1);
    const T lg = sub(l, g);
    T q = add(quo(mul(lg, lg), T(4)), mul(h, h));
    q = q < T(0) ? T(0) : q;  // clamp(min=0), NaN kept
    const T mu = sub(quo(add(l, g), T(2)), root(q));
    const T c = sub(mu, l);
    const T v0 = add(mul(h, w0), mul(c, u0));
    const T v1 = add(mul(h, w1), mul(c, u1));
    const T vn = root(dot(v0, v1, v0, v1));
    const T vs = vn > tiny ? vn : T(1);
    if (rn > small && vn > tiny) {
      w0 = quo(v0, vs);
      w1 = quo(v1, vs);
    }
  }
  T tw0, tw1;
  tmv(t, w0, w1, lane, tw0, tw1);
  const T l = dot(w0, w1, tw0, tw1);
  T* wi = w + inst * m;
  if (i0 < m) wi[i0] = w0;
  if (i1 < m) wi[i1] = w1;
  if (lane == 0) lam[inst] = l;
}

template <typename T>
int launch(const T* alphas, long long sa, const T* betas, long long sb,
           T* lam, T* w, int B, int m, int iters, cudaStream_t stream) {
  if (B < 1 || m < 1 || m > 64) return (int)cudaErrorInvalidValue;
  ritz_kernel<T><<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      alphas, sa, betas, sb, lam, w, B, m, iters);
  return (int)cudaGetLastError();
}

}  // namespace

// alphas (B, m) and betas (B, m - 1) with unit stride along the row and row
// strides sa, sb (elements); lam (B,) and w (B, m) contiguous
extern "C" int tn_tridiag_ritz_f32(const float* alphas, long long sa,
                                   const float* betas, long long sb,
                                   float* lam, float* w, int B, int m,
                                   int iters, void* stream) {
  return launch(alphas, sa, betas, sb, lam, w, B, m, iters,
                (cudaStream_t)stream);
}

extern "C" int tn_tridiag_ritz_f64(const double* alphas, long long sa,
                                   const double* betas, long long sb,
                                   double* lam, double* w, int B, int m,
                                   int iters, void* stream) {
  return launch(alphas, sa, betas, sb, lam, w, B, m, iters,
                (cudaStream_t)stream);
}
