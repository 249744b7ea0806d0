// Grid-wide Lanczos of one site's local eigensolve: one cooperative,
// persistent launch runs all m steps of every instance, with the whole card
// on each step.  Shared by the streamed whole-Lanczos kernel
// (fused_lanczos_streamed.cu, basis out) and the two-pass Lanczos
// (fused_lanczos_2pass.cu, fact and replay).
//
// Why: the TPU kernels these replace exist because 16 MB of VMEM holds
// neither the basis nor the recurrence vectors at chi >= 384.  On the H100
// the basis lives in device memory anyway (fused_lanczos.cu); what is
// missing at a batch of one is parallelism: the one-block-per-instance
// kernel runs a chi=512 solve (384 stage-1 and 128 stage-2 64x64 tiles per
// matvec) on one SM of 132.  Here every block of a grid sized to fill the
// card (occupancy x SMs, all resident) walks the tiles of all instances:
//
//   init: |x0|^2 partials -> sync -> v0 = x0/|x0|                   2 syncs
//   step: stage 1 tiles -> sync -> stage 2 tiles, one <v, w> partial
//         per tile -> sync -> alpha, w -= alpha v + beta' v', one |w|^2
//         partial per segment -> sync -> beta, v_next -> sync     4 syncs
//
// cooperative_groups' grid.sync() stands where fused_lanczos.cu has
// __syncthreads().  Reductions across blocks are deterministic: a tile or
// segment job writes its partial to a fixed slot of a scratch row, and
// after the barrier every block that needs the total sums the row in one
// fixed order.  No float atomics: the bits of every alpha, beta and vector
// depend on the operands only, not on the grid size or the schedule, so
// the replay pass regenerates the fact pass's basis exactly.  The update
// w - alpha v - beta' v' is two explicit fused multiply-adds for the same
// reason.  No tensor cores (see heff.cuh).
#pragma once

#include <cooperative_groups.h>

#include "heff.cuh"

namespace lgrid {

namespace cg = cooperative_groups;

constexpr int PER_THREAD = 16;
constexpr int SEG = heff::THREADS * PER_THREAD;  // elements per segment job

// BASIS: emit the Krylov basis V (B, m, n) and ab (the streamed kernel).
// FACT: emit ab only; v_j and v_{j-1} live in a two-slot ring.
// REPLAY: read ab and the Ritz weights, rerun the recurrence and
// accumulate y = sum_j wts[j] v_j.
enum Mode { BASIS = 0, FACT = 1, REPLAY = 2 };

template <typename T>
struct Args {
  const T* W;          // (M,M,d,d), or one per instance with w_stride
  long long w_stride;
  const T* Lt;         // (B,M,chi,chi)
  const T* Rt;         // (B,M,chi,chi)
  const T* x0;         // (B,n), n = d*chi*chi
  T* V;                // BASIS: (B,m,n); FACT, REPLAY: ring (B,2,n)
  T* ab;               // (B,2,m): written by BASIS/FACT, read by REPLAY
  const T* wts;        // REPLAY: (B,m)
  T* y;                // REPLAY: (B,n)
  T* P;                // scratch (B,M*d,chi,chi)
  T* w;                // scratch (B,n)
  T* apart;            // scratch (B,d*nt*nt): <v,w> partial per tile
  T* bpart;            // scratch (B,nseg): norm partial per segment
  T* alive0;           // scratch (B,): 1 if |x0| > delta
  int B, chi, d, M, m;
  T delta;
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// w - alpha v - beta_prev v_prev, rounded the same way in every mode
template <typename T>
__device__ __forceinline__ T lanczos_update(T w, T v, T vp, T alpha,
                                            T beta_prev) {
  return fma_rn(-beta_prev, vp, fma_rn(-alpha, v, w));
}

template <typename T, int MODE>
__global__ void __launch_bounds__(heff::THREADS)
    lanczos_grid_kernel(Args<T> a) {
  __shared__ heff::Smem<T> sm;
  cg::grid_group grid = cg::this_grid();
  const T LARGE = T(1e10);
  const int tid = threadIdx.x, nb = gridDim.x, bid = blockIdx.x;
  const int chi = a.chi, d = a.d, M = a.M, m = a.m;
  const size_t plane = (size_t)chi * chi;
  const size_t n = d * plane;
  const int nseg = (int)((n + SEG - 1) / SEG);
  const int nt = heff::num_tiles(chi);
  const int jobs1 = M * d * nt * nt, jobs2 = d * nt * nt;
  auto vec = [&](int b, int j) -> T* {
    return MODE == BASIS ? a.V + ((size_t)b * m + j) * n
                         : a.V + ((size_t)b * 2 + (j & 1)) * n;
  };
  auto elem = [&](int s, int k) -> size_t {
    return (size_t)s * SEG + (size_t)k * heff::THREADS + tid;
  };

  // v0 = x0 / |x0| (zero and dead when |x0| <= delta)
  for (int job = bid; job < a.B * nseg; job += nb) {
    const int b = job / nseg, s = job % nseg;
    const T* x = a.x0 + b * n;
    T part = T(0);
    for (int k = 0; k < PER_THREAD; ++k) {
      const size_t e = elem(s, k);
      if (e < n) part += x[e] * x[e];
    }
    part = heff::block_sum(part, sm);
    if (tid == 0) a.bpart[(size_t)b * nseg + s] = part;
  }
  grid.sync();
  for (int job = bid; job < a.B * nseg; job += nb) {
    const int b = job / nseg, s = job % nseg;
    const T nrm =
        sqrt(heff::ordered_sum(a.bpart + (size_t)b * nseg, nseg, sm));
    const bool alive = nrm > a.delta;
    const T inv = alive ? T(1) / nrm : T(0);
    const T* x = a.x0 + b * n;
    T* v = vec(b, 0);
    for (int k = 0; k < PER_THREAD; ++k) {
      const size_t e = elem(s, k);
      if (e >= n) continue;
      v[e] = x[e] * inv;
      if (MODE == REPLAY) a.y[b * n + e] = T(0);
    }
    if (s == 0 && tid == 0) a.alive0[b] = alive ? T(1) : T(0);
  }
  grid.sync();

  const int steps = MODE == REPLAY ? m - 1 : m;
  for (int j = 0; j < steps; ++j) {
    // w = H v_j, stage 1 then stage 2 (with <v_j, w> per tile)
    for (int job = bid; job < a.B * jobs1; job += nb) {
      const int b = job / jobs1;
      heff::stage1_tile(job % jobs1, a.Lt + b * M * plane, vec(b, j),
                        a.P + b * M * d * plane, chi, d, sm);
    }
    grid.sync();
    int loaded = -1;
    for (int job = bid; job < a.B * jobs2; job += nb) {
      const int b = job / jobs2;
      if (b != loaded) {
        heff::load_couplings(a.W + b * a.w_stride, d, M, sm);
        loaded = b;
      }
      T p = heff::stage2_tile(job % jobs2, a.Rt + b * M * plane,
                              a.P + b * M * d * plane, a.w + b * n, chi, d,
                              M, sm, MODE == REPLAY ? nullptr : vec(b, j));
      if (MODE != REPLAY) {
        p = heff::block_sum(p, sm);
        if (tid == 0) a.apart[(size_t)b * jobs2 + job % jobs2] = p;
      }
    }
    grid.sync();

    // the three-term update
    for (int job = bid; job < a.B * nseg; job += nb) {
      const int b = job / nseg, s = job % nseg;
      T* ab = a.ab + (size_t)b * 2 * m;
      const T* v = vec(b, j);
      const T* vp = j > 0 ? vec(b, j - 1) : v;  // weight 0 when j == 0
      T* wv = a.w + b * n;
      const T beta_prev = j > 0 ? ab[m + j - 1] : T(0);
      if (MODE == REPLAY) {
        // alpha, beta from the fact pass; a dead step's +1e10 sentinel
        // is clamped (its v is zero, so alpha v is zero either way)
        T alpha = ab[j];
        if (alpha >= LARGE || alpha <= -LARGE) alpha = T(0);
        const T beta = ab[m + j];
        const T inv = beta > a.delta ? T(1) / beta : T(0);
        const T wt = a.wts[(size_t)b * m + j];
        T* vn = vec(b, j + 1);  // the slot of v_{j-1}, read just before
        T* yb = a.y + b * n;
        for (int k = 0; k < PER_THREAD; ++k) {
          const size_t e = elem(s, k);
          if (e >= n) continue;
          const T ve = v[e];
          const T we = lanczos_update(wv[e], ve, vp[e], alpha, beta_prev);
          yb[e] += wt * ve;
          vn[e] = we * inv;
        }
      } else {
        const T alpha =
            heff::ordered_sum(a.apart + (size_t)b * jobs2, jobs2, sm);
        const bool alive = j == 0 ? a.alive0[b] != T(0) : beta_prev != T(0);
        T part = T(0);
        for (int k = 0; k < PER_THREAD; ++k) {
          const size_t e = elem(s, k);
          if (e >= n) continue;
          const T we = lanczos_update(wv[e], v[e], vp[e], alpha, beta_prev);
          wv[e] = we;
          part += we * we;
        }
        part = heff::block_sum(part, sm);
        if (tid == 0) {
          a.bpart[(size_t)b * nseg + s] = part;
          if (s == 0) ab[j] = alive ? alpha : LARGE;
        }
      }
    }
    grid.sync();
    if (MODE == REPLAY || j == m - 1) continue;

    // beta = |w|; v_{j+1} = w / beta, zero once the chain is dead
    for (int job = bid; job < a.B * nseg; job += nb) {
      const int b = job / nseg, s = job % nseg;
      T* ab = a.ab + (size_t)b * 2 * m;
      const T beta =
          sqrt(heff::ordered_sum(a.bpart + (size_t)b * nseg, nseg, sm));
      const bool alive = j == 0 ? a.alive0[b] != T(0) : ab[m + j - 1] != T(0);
      const bool alive_next = alive && beta > a.delta;
      const T inv = beta > a.delta ? T(1) / beta : T(0);
      const T keep = alive_next ? T(1) : T(0);
      const T* wv = a.w + b * n;
      T* vn = vec(b, j + 1);
      for (int k = 0; k < PER_THREAD; ++k) {
        const size_t e = elem(s, k);
        if (e < n) vn[e] = wv[e] * inv * keep;
      }
      if (s == 0 && tid == 0) ab[m + j] = alive_next ? beta : T(0);
    }
    grid.sync();
  }

  if (MODE == REPLAY) {
    for (int job = bid; job < a.B * nseg; job += nb) {
      const int b = job / nseg, s = job % nseg;
      const T wt = a.wts[(size_t)b * m + m - 1];
      const T* v = vec(b, m - 1);
      T* yb = a.y + b * n;
      for (int k = 0; k < PER_THREAD; ++k) {
        const size_t e = elem(s, k);
        if (e < n) yb[e] += wt * v[e];
      }
    }
  } else if (bid == 0) {
    for (int b = tid; b < a.B; b += heff::THREADS)
      a.ab[(size_t)b * 2 * m + 2 * m - 1] = T(0);
  }
}

// One cooperative launch with every block resident: the grid is the
// occupancy of the kernel times the SM count.  Writes the grid size to
// *grid_out; returns the launch's cudaError_t.
template <typename T, int MODE>
int launch(Args<T> a, int* grid_out, cudaStream_t stream) {
  auto kern = lanczos_grid_kernel<T, MODE>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        heff::THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const int grid = per_sm * sms;
  *grid_out = grid;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(heff::THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace lgrid
