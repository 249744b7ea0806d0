// Grid-wide Lanczos of one site's local eigensolve: one cooperative,
// persistent launch runs all m steps of every instance, with the whole card
// on each step.  Shared by the streamed whole-Lanczos kernel
// (fused_lanczos_streamed.cu, basis out; replaces kernels.py
// make_fused_lanczos_streamed) and the two-pass Lanczos
// (fused_lanczos_2pass.cu, fact and replay; replaces kernels.py
// make_fused_lanczos_2pass).
//
// Why: the TPU kernels these replace exist because 16 MB of VMEM holds
// neither the basis nor the recurrence vectors at chi >= 384.  On the H100
// the basis lives in device memory anyway (fused_lanczos.cu); what is
// missing at a batch of one is parallelism: the one-block-per-instance
// kernel runs a chi=512 solve on one SM of 132.  Here every block of a
// grid sized to fill the card (occupancy x SMs, all resident) walks the
// tile jobs of all instances.
//
// What bounds it on the H100: operations.  A matvec is 4 M d chi^3 flops
// (1.36 GFLOP at chi=384, 3.22 at 512; M=3, d=2) against L, R and v read
// and w written once: 1000-2000 flops per byte.  fp32-accurate products by
// 3xTF32 on the tensor cores are bounded by 3 x flops at 495 TFLOP/s
// (2.7 us per GFLOP), the fp32 SIMT core by flops at 67 TFLOP/s (15 us).
//
// Design, f32: the matvec of K7 (gemm_tc32.cuh) spread over the grid, on
// its 3xTF32 mma.sync core (big/small split by integer ops, m16n8k8 TF32,
// a 3-stage 16-byte cp.async ring in dynamic shared memory):
//   stage 1  P[(w,c)][(t,b)] = sum_a Lt[w][c][a] v[t][a][b], one
//            (M chi) x (d chi) GEMM of depth chi per instance, cut into
//            tile jobs;
//   fold     Q[(v,c)][(s,b)] = sum_{w,t} W[w,v,s,t] P[(w,c)][(t,b)], once
//            per element, in place (tc32::fold_in_place), over the grid;
//   stage 2  slot_k[s] = sum_{v in k} Q_vs (chi x chi) Rt_v, S slots (the
//            split over v), tile jobs of depth (M/S) chi;
// the recurrence pass sums the slots in order 0..S-1 before it takes
// <v, w>.  Each block's jobs of a stage are one gemm_stream, so the copies
// of its next job land while the current one computes.  The host plan
// (ops/kernels.py lgrid_plan) picks the block tile of both stages and S
// (1 or M), the same for every mode: 128x128 at one block an SM (109 KB
// of shared memory, 255 registers) where stage 1 gives at least half the
// SMs a job, else 64x64 at two (60 KB, 128 registers each).  At B=1,
// chi=384: 64x64, S=3, 216 jobs a stage (72 in stage 2 without the
// split), which ran the streamed kernel in 1.03 ms against 1.45 at
// 128x128; at chi=512: 128x128, S=3, 96 jobs a stage, 1.90 ms against
// 2.26 at 64x64 (benchmarks/lgrid_breakdown.py, NVIDIA H100 80GB HBM3 at
// 700 W).  There the two GEMM stages take ~85% of the time, at 15-20
// TFLOP/s: one job of 12-16 ring stages a block, too short to hide the
// ring's fill and the epilogue.
// Both stages use stage_mma<FINE> (as fused_lanczos.cu: <v, H v> sums the
// outputs, so the tensor cores' round-toward-zero would survive in alpha).
// <v, w>, |w|^2 and |x0|^2 sum exact f32 products in f64, each block's
// share then the fixed block tree, and per instance the segment partials
// in a fixed order, rounded to f32 once.  The breakdown operators are
// small integers, which split exactly, so those chains equal the twin's
// bits.  f64 keeps the SIMT tile core of heff.cuh (stage 2 over 64x64
// tiles M chi deep, the couplings folded while staged: S=1).
//
// Grid barriers (cooperative_groups' grid.sync()):
//   init:  |x0|^2 partials | v0 = x0/|x0|                          2
//   step:  stage 1 | fold | stage 2 | <v, w> | alpha, w -= alpha v
//          + beta' v', |w|^2 | beta, v_next = w/beta              6
//          (5 on the last step; f64: 5, no fold)
//   replay step: stage 1 | fold | stage 2 | w, y += wt v, v_next   4
//          (alpha and beta are inputs, so one pass does the update)
// so fact runs 61 barriers at m=10, replay 38: ~1.3 us each, 0.08 ms of a
// streamed solve, and the recurrence passes ~0.14 ms more
// (benchmarks/lgrid_breakdown.py: the kernel with the GEMM jobs, the fold
// and the passes left out; H100 80GB HBM3, 700 W).
//
// Reductions across blocks are deterministic: a segment job writes its
// partial to a fixed slot, and after the barrier every block that needs
// the total sums the row in one fixed order; a tile's products depend on
// its operands only, not on the block that runs it.  No float atomics: the
// bits of every alpha, beta and vector depend on the operands, not on the
// grid size or the schedule, so the replay pass regenerates the fact
// pass's basis exactly and fact's ab equals the streamed kernel's.  The
// update w - alpha v - beta' v' is two explicit fused multiply-adds for
// the same reason.
#pragma once

#include <cooperative_groups.h>

#include "gemm_tc32.cuh"

namespace lgrid {

namespace cg = cooperative_groups;

constexpr int THREADS = tc32::THREADS;  // 256, as heff::THREADS
constexpr int PER_THREAD = 4;
constexpr int SEG = THREADS * PER_THREAD;  // elements per segment job

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
  T* P;                // scratch (B,M*d*chi*chi): stage 1, then the fold
  T* slots;            // scratch (B,S,n): stage 2; slot 0 then holds w
  double* apart;       // scratch (B,nseg): <v,w> partial per segment
  double* bpart;       // scratch (B,nseg): norm partial per segment
  T* alive0;           // scratch (B,): 1 if |x0| > delta
  int B, chi, d, M, m;
  int tile;            // f32: tc32::TileCode of both stages, T128x128
                       // (one block an SM) or T64x64 (two)
  int S;               // f32: the split of stage 2 over v (f64: 1)
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

// Krylov vector j of instance b: the basis, or its slot of the ring
template <typename T, int MODE>
__device__ __forceinline__ T* vec(const Args<T>& a, int b, int j) {
  const size_t n = (size_t)a.d * a.chi * a.chi;
  return MODE == BASIS ? a.V + ((size_t)b * a.m + j) * n
                       : a.V + ((size_t)b * 2 + (j & 1)) * n;
}

// The recurrence around matvec(j), which writes H v_j of every instance
// into the S slots (its own barriers inside, none at its end).  red:
// 33 doubles of shared memory.
template <typename T, int MODE, typename Matvec>
__device__ void lanczos(const Args<T>& a, double* red, Matvec matvec) {
  cg::grid_group grid = cg::this_grid();
  const T LARGE = T(1e10);
  const int tid = threadIdx.x, nb = gridDim.x, bid = blockIdx.x;
  const int m = a.m, S = a.S;
  const size_t n = (size_t)a.d * a.chi * a.chi;
  const int nseg = (int)((n + SEG - 1) / SEG);
  auto elem = [&](int s, int k) -> size_t {
    return (size_t)s * SEG + (size_t)k * THREADS + tid;
  };
  // w = the slots summed in order 0..S-1
  auto wsum = [&](int b, size_t e) -> T {
    const T* p = a.slots + (size_t)b * S * n + e;
    T w = p[0];
    for (int k = 1; k < S; ++k) w += p[k * n];
    return w;
  };

  // v0 = x0 / |x0| (zero and dead when |x0| <= delta)
  for (int job = bid; job < a.B * nseg; job += nb) {
    const int b = job / nseg, s = job % nseg;
    const T* x = a.x0 + b * n;
    double part = 0.0;
    for (int k = 0; k < PER_THREAD; ++k) {
      const size_t e = elem(s, k);
      if (e < n) part += (double)x[e] * (double)x[e];
    }
    part = heff::block_sum(part, red);
    if (tid == 0) a.bpart[(size_t)b * nseg + s] = part;
  }
  grid.sync();
  for (int job = bid; job < a.B * nseg; job += nb) {
    const int b = job / nseg, s = job % nseg;
    const T nrm = (T)sqrt(heff::ordered_sum(a.bpart + (size_t)b * nseg, nseg,
                                            red));
    const bool alive = nrm > a.delta;
    const T inv = alive ? T(1) / nrm : T(0);
    const T* x = a.x0 + b * n;
    T* v = vec<T, MODE>(a, b, 0);
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
    matvec(j);
    grid.sync();

    if (MODE == REPLAY) {
      // alpha, beta from the fact pass; a dead step's +1e10 sentinel is
      // clamped (its v is zero, so alpha v is zero either way)
      for (int job = bid; job < a.B * nseg; job += nb) {
        const int b = job / nseg, s = job % nseg;
        const T* ab = a.ab + (size_t)b * 2 * m;
        T alpha = ab[j];
        if (alpha >= LARGE || alpha <= -LARGE) alpha = T(0);
        const T beta_prev = j > 0 ? ab[m + j - 1] : T(0);
        const T beta = ab[m + j];
        const T inv = beta > a.delta ? T(1) / beta : T(0);
        const T wt = a.wts[(size_t)b * m + j];
        const T* v = vec<T, MODE>(a, b, j);
        const T* vp = j > 0 ? vec<T, MODE>(a, b, j - 1) : v;  // weight 0
        T* vn = vec<T, MODE>(a, b, j + 1);  // vp's slot, read just before
        T* yb = a.y + b * n;
        for (int k = 0; k < PER_THREAD; ++k) {
          const size_t e = elem(s, k);
          if (e >= n) continue;
          const T ve = v[e];
          const T we = lanczos_update(wsum(b, e), ve, vp[e], alpha, beta_prev);
          yb[e] += wt * ve;
          vn[e] = we * inv;
        }
      }
      grid.sync();
      continue;
    }

    // alpha = <v_j, w>: one partial per segment
    for (int job = bid; job < a.B * nseg; job += nb) {
      const int b = job / nseg, s = job % nseg;
      const T* v = vec<T, MODE>(a, b, j);
      double part = 0.0;
      for (int k = 0; k < PER_THREAD; ++k) {
        const size_t e = elem(s, k);
        if (e < n) part += (double)v[e] * (double)wsum(b, e);
      }
      part = heff::block_sum(part, red);
      if (tid == 0) a.apart[(size_t)b * nseg + s] = part;
    }
    grid.sync();

    // the three-term update into slot 0, one |w|^2 partial per segment
    for (int job = bid; job < a.B * nseg; job += nb) {
      const int b = job / nseg, s = job % nseg;
      T* ab = a.ab + (size_t)b * 2 * m;
      const T* v = vec<T, MODE>(a, b, j);
      const T* vp = j > 0 ? vec<T, MODE>(a, b, j - 1) : v;  // weight 0
      T* wv = a.slots + (size_t)b * S * n;
      const T beta_prev = j > 0 ? ab[m + j - 1] : T(0);
      const T alpha = (T)heff::ordered_sum(a.apart + (size_t)b * nseg, nseg,
                                           red);
      const bool alive = j == 0 ? a.alive0[b] != T(0) : beta_prev != T(0);
      double part = 0.0;
      for (int k = 0; k < PER_THREAD; ++k) {
        const size_t e = elem(s, k);
        if (e >= n) continue;
        const T we = lanczos_update(wsum(b, e), v[e], vp[e], alpha, beta_prev);
        wv[e] = we;
        part += (double)we * (double)we;
      }
      part = heff::block_sum(part, red);
      if (tid == 0) {
        a.bpart[(size_t)b * nseg + s] = part;
        if (s == 0) ab[j] = alive ? alpha : LARGE;
      }
    }
    grid.sync();
    if (j == m - 1) continue;

    // beta = |w|; v_{j+1} = w / beta, zero once the chain is dead
    for (int job = bid; job < a.B * nseg; job += nb) {
      const int b = job / nseg, s = job % nseg;
      T* ab = a.ab + (size_t)b * 2 * m;
      const T beta = (T)sqrt(heff::ordered_sum(a.bpart + (size_t)b * nseg,
                                               nseg, red));
      const bool alive = j == 0 ? a.alive0[b] != T(0) : ab[m + j - 1] != T(0);
      const bool alive_next = alive && beta > a.delta;
      const T inv = beta > a.delta ? T(1) / beta : T(0);
      const T keep = alive_next ? T(1) : T(0);
      const T* wv = a.slots + (size_t)b * S * n;
      T* vn = vec<T, MODE>(a, b, j + 1);
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
      const T* v = vec<T, MODE>(a, b, m - 1);
      T* yb = a.y + b * n;
      for (int k = 0; k < PER_THREAD; ++k) {
        const size_t e = elem(s, k);
        if (e < n) yb[e] += wt * v[e];
      }
    }
  } else if (bid == 0) {
    for (int b = tid; b < a.B; b += THREADS)
      a.ab[(size_t)b * 2 * m + 2 * m - 1] = T(0);
  }
}

// ---------------------------------------------------------------------------
// f64: the SIMT tile core of heff.cuh
// ---------------------------------------------------------------------------

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) simt_kernel(Args<T> a) {
  __shared__ heff::Smem<T> sm;
  __shared__ double red[33];
  cg::grid_group grid = cg::this_grid();
  const int nb = gridDim.x, bid = blockIdx.x;
  const int chi = a.chi, d = a.d, M = a.M;
  const size_t plane = (size_t)chi * chi;
  const int nt = heff::num_tiles(chi);
  const int jobs1 = M * d * nt * nt, jobs2 = d * nt * nt;
  lanczos<T, MODE>(a, red, [&](int j) {
    for (int job = bid; job < a.B * jobs1; job += nb) {
      const int b = job / jobs1;
      heff::stage1_tile(job % jobs1, a.Lt + b * M * plane,
                        vec<T, MODE>(a, b, j), a.P + b * M * d * plane, chi,
                        d, sm);
    }
    grid.sync();
    int loaded = -1;
    for (int job = bid; job < a.B * jobs2; job += nb) {
      const int b = job / jobs2;
      if (b != loaded) {
        heff::load_couplings(a.W + b * a.w_stride, d, M, sm);
        loaded = b;
      }
      heff::stage2_tile(job % jobs2, a.Rt + b * M * plane,
                        a.P + b * M * d * plane, a.slots + b * d * plane, chi,
                        d, M, sm);
    }
  });
}

// ---------------------------------------------------------------------------
// f32: the 3xTF32 tensor-core tile streams of gemm_tc32.cuh
// ---------------------------------------------------------------------------

// This block's share of jobs: bid, bid + nb, ...
__device__ __forceinline__ int my_jobs(int jobs) {
  return (int)blockIdx.x < jobs ? (jobs - 1 - (int)blockIdx.x) / gridDim.x + 1
                                : 0;
}

// Stage 1 of step j: job (instance, row tile, t, column tile), chi deep.
template <int BM, int BN, int MODE>
__device__ void tc_stage1(const Args<float>& a, int j, bool vl, float* ring) {
  using Tile = tc32::Tile<BM, BN>;
  constexpr int BK = tc32::BK;
  const int chi = a.chi, d = a.d, M = a.M, nb = gridDim.x, bid = blockIdx.x;
  const size_t plane = (size_t)chi * chi, ldp = (size_t)d * chi;
  const int ct = (chi + BN - 1) / BN, rt = (M * chi + BM - 1) / BM;
  const int per = rt * d * ct;
  auto decode = [&](int i, int& b, int& r0, int& t, int& c0) {
    const int job = bid + i * nb;
    b = job / per;
    const int r = job - b * per;
    r0 = (r / (d * ct)) * BM, t = (r / ct) % d, c0 = (r % ct) * BN;
  };
  float acc[Tile::MT][Tile::NT][4] = {};
  tc32::gemm_stream<BM, BN, true>(
      my_jobs(a.B * per), (chi + BK - 1) / BK,
      [&](int i, int q, float* As, float* Bs) {
        int b, r0, t, c0;
        decode(i, b, r0, t, c0);
        tc32::load_stage<BM, BN>(
            As, Bs, a.Lt + b * M * plane + (size_t)r0 * chi + q * BK, chi,
            vec<float, MODE>(a, b, j) + t * plane + (size_t)q * BK * chi + c0,
            chi, M * chi - r0, chi - c0, chi - q * BK, vl);
      },
      [&](int i, const float(&acc)[Tile::MT][Tile::NT][4]) {
        int b, r0, t, c0;
        decode(i, b, r0, t, c0);
        const int rows = M * chi - r0, cols = chi - c0;
        float* out = a.P + b * M * d * plane + r0 * ldp + t * chi + c0;
        tc32::for_each_acc<BM, BN>(acc, [&](int r, int c, float x) {
          if (r < rows && c < cols) out[(size_t)r * ldp + c] = x;
        });
      },
      acc, ring);
}

// Stage 2: job (instance, slot k, s, output tile), (M/S) chi deep, v
// major; slot k of w_s = sum over its v of Q_vs Rt_v.
template <int BM, int BN>
__device__ void tc_stage2(const Args<float>& a, bool vl, float* ring) {
  using Tile = tc32::Tile<BM, BN>;
  constexpr int BK = tc32::BK;
  const int chi = a.chi, d = a.d, M = a.M, S = a.S, nb = gridDim.x,
            bid = blockIdx.x;
  const size_t plane = (size_t)chi * chi, ldp = (size_t)d * chi;
  const size_t n = d * plane;
  const int ctr = (chi + BM - 1) / BM, ctc = (chi + BN - 1) / BN;
  const int tiles = ctr * ctc, per = S * d * tiles;
  const int nkv = (chi + BK - 1) / BK, vs = M / S;
  auto decode = [&](int i, int& b, int& k, int& s, int& r0, int& c0) {
    const int job = bid + i * nb;
    b = job / per;
    int r = job - b * per;
    k = r / (d * tiles);
    r -= k * d * tiles;
    s = r / tiles;
    r -= s * tiles;
    r0 = (r / ctc) * BM, c0 = (r % ctc) * BN;
  };
  float acc[Tile::MT][Tile::NT][4] = {};
  tc32::gemm_stream<BM, BN, true>(
      my_jobs(a.B * per), vs * nkv,
      [&](int i, int q, float* As, float* Bs) {
        int b, k, s, r0, c0;
        decode(i, b, k, s, r0, c0);
        const int kv = q / nkv, kt = q - kv * nkv, v = k * vs + kv;
        tc32::load_stage<BM, BN>(
            As, Bs,
            a.P + b * M * n + ((size_t)v * chi + r0) * ldp + s * chi + kt * BK,
            (int)ldp,
            a.Rt + b * M * plane + v * plane + (size_t)kt * BK * chi + c0,
            chi, chi - r0, chi - c0, chi - kt * BK, vl);
      },
      [&](int i, const float(&acc)[Tile::MT][Tile::NT][4]) {
        int b, k, s, r0, c0;
        decode(i, b, k, s, r0, c0);
        const int rows = chi - r0, cols = chi - c0;
        float* out = a.slots + ((size_t)b * S + k) * n + s * plane +
                     (size_t)r0 * chi + c0;
        tc32::for_each_acc<BM, BN>(acc, [&](int r, int c, float x) {
          if (r < rows && c < cols) out[(size_t)r * chi + c] = x;
        });
      },
      acc, ring);
}

// MC, NTC: M and d at compile time for the fold (the path shape M=3,
// d=2), or 0: at run time.  BM x BN: the block tile of both stages, at
// MINB blocks an SM (tc32::min_blocks: the register budget).
template <int MODE, int MC, int NTC, int BM, int BN>
__global__ void __launch_bounds__(THREADS, (tc32::min_blocks<BM, BN>()))
    tc_kernel(Args<float> a) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ float cs[heff::MAX_COUPLINGS];  // cs[(w*d+t)*M*d + v*d+s]
  __shared__ double red[33];
  cg::grid_group grid = cg::this_grid();
  const int chi = a.chi, d = a.d, M = a.M;
  const size_t n = (size_t)d * chi * chi;
  // 16-byte cp.async where every row start is 16-byte aligned
  const bool vl = chi % 4 == 0 && (((uintptr_t)a.Lt | (uintptr_t)a.Rt |
                                    (uintptr_t)a.V | (uintptr_t)a.P) & 15) == 0;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  const int step = gridDim.x * THREADS;
  lanczos<float, MODE>(a, red, [&](int j) {
    tc_stage1<BM, BN, MODE>(a, j, vl, ring);
    grid.sync();
    for (int b = 0; b < a.B; ++b) {
      if (b == 0 || a.w_stride) {
        __syncthreads();  // earlier readers of cs are done
        tc32::load_fold_couplings(cs, a.W + b * a.w_stride, M, d);
        __syncthreads();
      }
      tc32::fold_in_place<MC, NTC>(cs, a.P + b * M * n, chi, d, M, first,
                                   step);
    }
    grid.sync();
    tc_stage2<BM, BN>(a, vl, ring);
  });
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// One cooperative launch with every block resident: the grid is the
// kernel's occupancy at `smem` bytes of dynamic shared memory times the SM
// count.  Writes the grid size to *grid_out; returns the launch's
// cudaError_t (a grid that does not fit never launches).
template <typename T>
int launch_coop(void (*kern)(Args<T>), Args<T> a, int smem, int* grid_out,
                cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = per_sm * sms;
  *grid_out = grid;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// f64: the SIMT kernel (no split).
template <int MODE>
int launch(Args<double> a, int* grid, cudaStream_t stream) {
  if (a.S != 1) return (int)cudaErrorInvalidValue;
  return launch_coop(simt_kernel<double, MODE>, a, 0, grid, stream);
}

template <int MODE, int BM, int BN>
int launch_tile(Args<float> a, int* grid, cudaStream_t stream) {
  constexpr int smem = tc32::Tile<BM, BN>::SMEM;
  if (a.M == 3 && a.d == 2)
    return launch_coop(tc_kernel<MODE, 3, 2, BM, BN>, a, smem, grid, stream);
  return launch_coop(tc_kernel<MODE, 0, 0, BM, BN>, a, smem, grid, stream);
}

// f32: the tensor-core kernel on the plan's tile and split.
template <int MODE>
int launch(Args<float> a, int* grid, cudaStream_t stream) {
  if (a.S < 1 || a.M % a.S || a.M * a.d > tc32::MAX_MN)
    return (int)cudaErrorInvalidValue;
  if (a.tile == tc32::T128x128)
    return launch_tile<MODE, 128, 128>(a, grid, stream);
  if (a.tile == tc32::T64x64) return launch_tile<MODE, 64, 64>(a, grid, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace lgrid
