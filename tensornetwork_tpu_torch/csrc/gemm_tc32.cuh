// The f32 GEMM core of the large-chi streamed matvecs (streamed_matvec.cu,
// streamed_matvec_xl.cu), of the resident Lanczos kernel
// (fused_lanczos.cu, whose matvec streams 64 x 64 tiles through
// gemm_stream inside one block per instance), of the grid-wide Lanczos
// kernels (lanczos_grid.cuh, the same streams spread over every block of
// the card, with the fold in place), and of the batched matvec
// (heff_matvec.cu: the streamed matvec's stages with FINE sums):
// fp32-accurate products on
// the tensor cores by 3xTF32, and the streamed matvec built from it as two
// large GEMMs and a coupling fold.
//
// Index conventions (kernel layout, see ops/kernels.py prepare_operands):
//   Lt[w][c][a]   C[w][v][s][t]   Rt[v][b][d]   x[t][a][b]  ->  y[s][c][d]
// Stage 1 (one GEMM per instance and contraction chunk k3):
//   P[k3][(w,c)][(t,b)] = sum_{a in k3} Lt[w][c][a] x[t][a][b]
//   an (M chi) x (nt chi) output; a column tile lies within one t.
// Fold (a bandwidth pass, one thread per (c, b)):
//   Q[s][c][(v,b)] = sum_{w,t} C[w,v,s,t] sum_k3 P[k3][(w,c)][(t,b)]
//   the K3 slots summed in order 0..K3-1, then the couplings applied.
// Stage 2 (one GEMM per s): y_s = Q_s (chi x M chi) @ Rt (M chi x chi),
//   Rt[v][b][d] read as one row-major (M chi) x chi matrix; each output
//   tile writes its share of <x, y> to a fixed slot, and
//   heff::ordered_sum_kernel sums the slots of an instance in order.
// Each stage is 2 M nt chi^3 flops, the least of the orders (folding the
// couplings into x or R first costs M or nt times more).
//
// The GEMM core: a BM x BN block tile (128x128, 128x64 or 64x64, picked
// on the host so that the grid covers the card), 8 warps in a 2 x 4
// layout, each on a (BM/2) x (BN/4) warp tile of m16n8k8 fragments; the
// contraction in 32-deep steps through a 3-stage ring in dynamic shared
// memory, filled by 16-byte cp.async.cg (4-byte cp.async.ca where a row
// is not 16-byte aligned), with zero fill past the ragged edges.  Rows of
// the A ring are padded to 36 words and rows of the B ring to BN + 8, so
// the fragment loads of a warp hit 32 distinct banks.
//
// Products: mma.sync m16n8k8 tf32 with f32 accumulation.  Each operand
// is split as it leaves shared memory into big = rna_tf32(a) and small =
// rna_tf32(a - big) (by integer ops: the cvt instruction is a
// quarter-rate conversion), and a_small b_big + a_big b_small + a_big
// b_big are accumulated in that order (CUTLASS's 3xTF32).  The dropped
// a_small b_small and the rounding of small keep the products within a
// few f32 ulps, where one TF32 product keeps ~3 decimal digits and breaks
// the variational bound of the Lanczos projection.  The tensor cores
// round the f32 sum of each mma toward zero, a bias that grows with the
// number of mmas into one accumulator (12x the f32 twin's error against
// f64 at chi=128, measured on the card); so the 12 mmas of each 32-deep
// stage start from zero, and their sum joins the accumulator by an f32
// add, which rounds to nearest.  A warp holds the split B fragments of a
// whole stage and walks its A fragments row block by row block.  Values
// with at most 22 significant bits (small integers, 1.0, 0) split
// exactly, so their products are exact.
//
// No float atomics: every output element and every <x, y> share is
// written by one thread to a fixed place, and a second launch gives the
// same bits.  f32 only; the f64 instances of the streamed matvecs keep
// the SIMT tile GEMM of heff.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "heff.cuh"

namespace tc32 {

constexpr int BK = 32;        // contraction depth of one ring stage
constexpr int STAGES = 3;     // ring depth
constexpr int THREADS = 256;  // 8 warps, 2 x 4
constexpr int APAD = 4;       // A ring row pitch BK + 4: conflict-free
constexpr int BPAD = 8;       // B ring row pitch BN + 8: conflict-free
constexpr int MAX_MN = 32;    // M*nt, from M*M*nt*nt <= heff::MAX_COUPLINGS
constexpr int FOLD_THREADS = 256;

// The tile shapes the host may pick (ops/kernels.py _TC32_TILES).
enum TileCode { T128x128 = 0, T128x64 = 1, T64x64 = 2 };

template <int BM, int BN>
struct Tile {
  static constexpr int WM = BM / 2, WN = BN / 4;   // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8;  // fragments per warp
  static constexpr int AP = BK + APAD, BP = BN + BPAD;
  static constexpr int A_STAGE = BM * AP, B_STAGE = BK * BP;  // words
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// dst (shared) <- the first `bytes` of src (global), the rest of 16 zeroed
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as an f32 bit pattern: the bits of cvt.rna.tf32.f32 for finite x, by
// two integer ops (half of the 13 dropped bits added to the magnitude,
// then cleared) where the conversion unit would take a quarter-rate F2F
// per value.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (to ~2^-22 of x), both TF32, held as f32 bit patterns.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

// d += a (16x8, row) @ b (8x8, col) on the tensor cores, TF32 in, f32 out
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One ring stage: A[0:BM, 0:BK] (row-major, lda) and B[0:BK, 0:BN]
// (row-major, ldb), zero past `rows` rows of A, `cols` columns of B and
// `klim` contraction indices.  With `vec` every row start is 16-byte
// aligned and one cp.async moves 4 words.
template <int BM, int BN>
__device__ __forceinline__ void load_stage(float* As, float* Bs,
                                           const float* A, int lda,
                                           const float* B, int ldb, int rows,
                                           int cols, int klim, bool vec) {
  using T = Tile<BM, BN>;
  if (vec) {
#pragma unroll
    for (int e = threadIdx.x; e < BM * BK / 4; e += THREADS) {
      const int r = e / (BK / 4), k = (e % (BK / 4)) * 4;
      const int n = r < rows ? max(0, min(4, klim - k)) : 0;
      cp16(As + r * T::AP + k, n ? A + (size_t)r * lda + k : A, 4 * n);
    }
#pragma unroll
    for (int e = threadIdx.x; e < BK * BN / 4; e += THREADS) {
      const int k = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const int n = k < klim ? max(0, min(4, cols - c)) : 0;
      cp16(Bs + k * T::BP + c, n ? B + (size_t)k * ldb + c : B, 4 * n);
    }
  } else {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, k = e % BK;
      const bool in = r < rows && k < klim;
      cp4(As + r * T::AP + k, in ? A + (size_t)r * lda + k : A, in ? 4 : 0);
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int k = e / BN, c = e % BN;
      const bool in = k < klim && c < cols;
      cp4(Bs + k * T::BP + c, in ? B + (size_t)k * ldb + c : B, in ? 4 : 0);
    }
  }
}

// acc += As (BM x BK, ring layout) @ Bs (BK x BN): one ring stage of the
// block's BM x BN tile on the tensor cores in 3xTF32.  FINE = false: the
// stage's 12 mmas of an output fragment chain into one fresh sum, added
// to acc once.  FINE = true: the small terms chain over the stage, but
// each 8-deep big x big product starts from zero and is added to acc on
// its own, so each f32 value passes one round-toward-zero instead of 12:
// the bias that shrinks every output alike, and so survives in a sum of
// many outputs (a Rayleigh quotient), falls ~10x, for 4 more f32 adds
// per output and stage.
template <int BM, int BN, bool FINE = false>
__device__ __forceinline__ void stage_mma(
    float (&acc)[Tile<BM, BN>::MT][Tile<BM, BN>::NT][4], const float* as,
    const float* bs) {
  using T = Tile<BM, BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp / 4) * T::WM, n0 = (warp % 4) * T::WN;
  const int g = lane / 4, q = lane % 4;
  constexpr int KQ = BK / 8;  // 8-deep mma steps per stage
  // the warp's B fragments of the whole stage, split once
  uint32_t bb[KQ][T::NT][2], bsm[KQ][T::NT][2];
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const float* p = bs + (kq * 8 + q) * T::BP + n0 + j * 8 + g;
      split(p[0], bb[kq][j][0], bsm[kq][j][0]);
      split(p[4 * T::BP], bb[kq][j][1], bsm[kq][j][1]);
    }
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
    uint32_t ab[KQ][4], asm_[KQ][4];
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      const float* p = as + (m0 + i * 16 + g) * T::AP + kq * 8 + q;
      split(p[0], ab[kq][0], asm_[kq][0]);
      split(p[8 * T::AP], ab[kq][1], asm_[kq][1]);
      split(p[4], ab[kq][2], asm_[kq][2]);
      split(p[8 * T::AP + 4], ab[kq][3], asm_[kq][3]);
    }
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      // the tensor cores round the f32 sum of each mma toward zero: the
      // stage's mmas go to fresh sums, which join the accumulator by f32
      // adds (round to nearest)
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (FINE) {
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq) {
          mma(d, asm_[kq], bb[kq][j]);
          mma(d, ab[kq], bsm[kq][j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq) {
          float big[4] = {0.f, 0.f, 0.f, 0.f};
          mma(big, ab[kq], bb[kq][j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += big[e];
        }
      } else {
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq) {
          mma(d, asm_[kq], bb[kq][j]);
          mma(d, ab[kq], bsm[kq][j]);
          mma(d, ab[kq], bb[kq][j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
      }
    }
  }
}

// A stream of BM x BN tile GEMMs through one STAGES-deep ring of 32-deep
// stages: job j (of njobs) has nk stages.  load(j, q, As, Bs) issues the
// copies of job j's stage q (load_stage); each job's product adds to acc,
// and epi(j, acc) takes job j's finished tile, after which acc is zeroed
// for the next job (the last job's sum stays in acc).  The ring runs on
// from one job to the next, so the copies of job j+1 land while job j
// computes; the (job, stage) counters step without a division.  Ends
// with every copy landed and a __syncthreads(), so the caller may reuse
// `smem`.
template <int BM, int BN, bool FINE = false, typename Load, typename Epi>
__device__ void gemm_stream(int njobs, int nk, Load load, Epi epi,
                            float (&acc)[Tile<BM, BN>::MT][Tile<BM, BN>::NT][4],
                            float* smem) {
  using T = Tile<BM, BN>;
  float* As = smem;
  float* Bs = smem + STAGES * T::A_STAGE;
  const int steps = njobs * nk;
  int ljob = 0, lq = 0;  // the next stage to load
  auto load_next = [&](int slot) {
    load(ljob, lq, As + slot * T::A_STAGE, Bs + slot * T::B_STAGE);
    if (++lq == nk) lq = 0, ++ljob;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_next(s);
    cp_commit();
  }
  int job = 0, q = 0;  // the stage computed now
  for (int t = 0; t < steps; ++t) {
    cp_wait<STAGES - 2>();  // step t has landed (this thread's copies)
    __syncthreads();        // ... everyone's; step t-1's slot is free
    if (t + STAGES - 1 < steps) load_next((t + STAGES - 1) % STAGES);
    cp_commit();
    stage_mma<BM, BN, FINE>(acc, As + (t % STAGES) * T::A_STAGE,
                            Bs + (t % STAGES) * T::B_STAGE);
    if (++q == nk) {
      epi(job, acc);
      q = 0;
      if (++job < njobs) {
#pragma unroll
        for (int i = 0; i < T::MT; ++i)
#pragma unroll
          for (int j = 0; j < T::NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
}

// acc += A[0:rows, 0:K] @ B[0:K, 0:cols] over this block's BM x BN tile
// (A and B point at the tile's first row / column), stage sums as
// stage_mma<FINE>.  Ends with every copy landed and a __syncthreads(), so
// the caller may reuse `smem`.  gemm_stream's loop for one job, kept
// apart: run through gemm_stream, K7/K8's stage 2 took 3% longer on an
// H100 80GB HBM3 at 700 W (benchmarks/sweep_kernels.py, in turns with the
// loop below).
template <int BM, int BN, bool FINE = false>
__device__ void gemm_tile(float (&acc)[Tile<BM, BN>::MT][Tile<BM, BN>::NT][4],
                          const float* A, int lda, const float* B, int ldb,
                          int K, int rows, int cols, bool vec, float* smem) {
  using T = Tile<BM, BN>;
  float* As = smem;
  float* Bs = smem + STAGES * T::A_STAGE;
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM, BN>(As + s * T::A_STAGE, Bs + s * T::B_STAGE, A + s * BK,
                         lda, B + (size_t)s * BK * ldb, ldb, rows, cols,
                         K - s * BK, vec);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();        // ... everyone's; stage kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      const int st = nxt % STAGES;
      load_stage<BM, BN>(As + st * T::A_STAGE, Bs + st * T::B_STAGE,
                         A + nxt * BK, lda, B + (size_t)nxt * BK * ldb, ldb,
                         rows, cols, K - nxt * BK, vec);
    }
    cp_commit();
    stage_mma<BM, BN, FINE>(acc, As + (kt % STAGES) * T::A_STAGE,
                            Bs + (kt % STAGES) * T::B_STAGE);
  }
  cp_wait<0>();
  __syncthreads();
}

// f(row, col, value) for each accumulator of this thread, (row, col)
// relative to the block tile
template <int BM, int BN, typename F>
__device__ __forceinline__ void for_each_acc(
    const float (&acc)[Tile<BM, BN>::MT][Tile<BM, BN>::NT][4], F f) {
  using T = Tile<BM, BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp / 4) * T::WM + lane / 4;
  const int n0 = (warp % 4) * T::WN + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(m0 + i * 16 + (e >> 1) * 8, n0 + j * 8 + (e & 1), acc[i][j][e]);
}

// cs[(w*nt+t)*M*nt + v*nt+s] = C[w][v][s][t], the couplings of one
// instance as fold_in_place reads them (the caller syncs around it).
__device__ __forceinline__ void load_fold_couplings(float* cs, const float* C,
                                                    int M, int nt) {
  const int mn = M * nt;
  for (int e = threadIdx.x; e < mn * mn; e += blockDim.x) {
    const int t = e % nt, s = (e / nt) % nt, v = (e / (nt * nt)) % M,
              w = e / (nt * nt * M);
    cs[(w * nt + t) * mn + v * nt + s] = C[e];
  }
}

// The coupling fold in place, over the elements first, first + step, ...
// of one instance's chi x chi (c, b) plane: the M*nt values
// P[(w,c)][(t,b)] of an element become Q[(v,c)][(s,b)] = sum_{w,t}
// cs[(w*nt+t)*M*nt + v*nt+s] P[(w,c)][(t,b)] at the same positions, so
// each thread reads and writes only its own elements.  MC, NTC: M and nt
// at compile time (all loads of an element in flight at once), or 0.
template <int MC, int NTC>
__device__ void fold_in_place(const float* cs, float* P, int chi, int nt_,
                              int M_, int first, int step) {
  const int M = MC ? MC : M_, nt = NTC ? NTC : nt_;
  const int mn = M * nt;
  const size_t ldp = (size_t)nt * chi, wstep = (size_t)chi * ldp;
  for (int e = first; e < chi * chi; e += step) {
    const int c = e / chi, col = e - c * chi;
    float* p = P + (size_t)c * ldp + col;
    if constexpr (MC > 0 && NTC > 0) {
      constexpr int MN = MC * NTC;
      float pv[MN], q[MN];
#pragma unroll
      for (int j = 0; j < MN; ++j) {
        pv[j] = p[(j / NTC) * wstep + (j % NTC) * chi];
        q[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < MN; ++j)
#pragma unroll
        for (int i = 0; i < MN; ++i) q[i] += cs[j * MN + i] * pv[j];
#pragma unroll
      for (int i = 0; i < MN; ++i)
        p[(i / NTC) * wstep + (i % NTC) * chi] = q[i];
    } else {
      float q[MAX_MN];
#pragma unroll
      for (int i = 0; i < MAX_MN; ++i) q[i] = 0.f;
      for (int j = 0; j < mn; ++j) {
        const float pv = p[(j / nt) * wstep + (j % nt) * chi];
        const float* cw = cs + j * mn;
#pragma unroll
        for (int i = 0; i < MAX_MN; ++i)
          if (i < mn) q[i] += cw[i] * pv;
      }
#pragma unroll
      for (int i = 0; i < MAX_MN; ++i)
        if (i < mn) p[(i / nt) * wstep + (i % nt) * chi] = q[i];
    }
  }
}

// Stage 1: one block per (row tile of M chi rows, column tile within one
// t) and per (instance, chunk k3) in blockIdx.y = b*K3 + k3.
// blocks per SM the register budget is set for: two at the smaller
// tiles; one at 128x128, whose 64 accumulators a thread spill at the
// 128-register cap of two
template <int BM, int BN>
constexpr int min_blocks() {
  return BM * BN >= 128 * 128 ? 1 : 2;
}

template <int BM, int BN, bool FINE = false>
__global__ void __launch_bounds__(THREADS, min_blocks<BM, BN>())
    stage1_kernel(const float* __restrict__ Lt, const float* __restrict__ x,
                  float* __restrict__ P, int chi, int nt, int M, int K3,
                  int vec) {
  using T = Tile<BM, BN>;
  extern __shared__ float4 smem4[];
  const size_t plane = (size_t)chi * chi;
  const int ncb = (chi + BN - 1) / BN;  // column tiles per t
  const int rt = blockIdx.x / (nt * ncb), ct = blockIdx.x % (nt * ncb);
  const int t = ct / ncb, r0 = rt * BM, c0 = (ct % ncb) * BN;
  const int k3 = blockIdx.y % K3;
  const size_t b = blockIdx.y / K3;
  const int ac = chi / K3, a0 = k3 * ac;  // this block's contraction chunk
  const int rows = M * chi - r0, cols = chi - c0;
  float acc[T::MT][T::NT][4] = {};
  gemm_tile<BM, BN, FINE>(acc, Lt + b * M * plane + (size_t)r0 * chi + a0, chi,
                    x + (b * nt + t) * plane + (size_t)a0 * chi + c0, chi, ac,
                    rows, cols, vec != 0, (float*)smem4);
  const size_t ldp = (size_t)nt * chi;
  float* out = P + (b * K3 + k3) * (size_t)M * chi * ldp + (size_t)r0 * ldp +
               (size_t)t * chi + c0;
  for_each_acc<BM, BN>(acc, [&](int r, int c, float v) {
    if (r < rows && c < cols) out[(size_t)r * ldp + c] = v;
  });
}

// The fold: one thread per (c, b) of an instance (blockIdx.y).  Reads the
// M*nt (times K3) P values of its element, writes its M*nt Q values.  MC,
// NTC: M and nt fixed at compile time, so that all of an element's loads
// are in flight at once (the path shapes: M=3, nt=2 or 4), or 0: read at
// run time, one (w, t) at a time.
template <int MC, int NTC>
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_kernel(const float* __restrict__ C, long long c_stride,
                const float* __restrict__ P, float* __restrict__ Q, int chi,
                int nt_, int M_, int K3) {
  __shared__ float cs[heff::MAX_COUPLINGS];  // cs[(w*nt+t)*M*nt + v*nt+s]
  const int M = MC ? MC : M_, nt = NTC ? NTC : nt_;
  const int mn = M * nt;
  const size_t b = blockIdx.y;
  for (int e = threadIdx.x; e < mn * mn; e += blockDim.x) {
    const int t = e % nt, s = (e / nt) % nt, v = (e / (nt * nt)) % M,
              w = e / (nt * nt * M);
    cs[(w * nt + t) * mn + v * nt + s] = C[b * c_stride + e];
  }
  __syncthreads();
  const size_t plane = (size_t)chi * chi;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= plane) return;
  const int c = (int)(e / chi), col = (int)(e % chi);
  const size_t ldp = (size_t)nt * chi, slot = (size_t)M * chi * ldp;
  const float* p = P + b * K3 * slot + (size_t)c * ldp + col;
  const size_t ldq = (size_t)M * chi;
  float* out = Q + b * nt * chi * ldq + (size_t)c * ldq + col;
  float q[MAX_MN];
#pragma unroll
  for (int i = 0; i < MAX_MN; ++i) q[i] = 0.f;
  if constexpr (MC > 0 && NTC > 0) {
    constexpr int MN = MC * NTC;
    float pv[MN];
#pragma unroll
    for (int j = 0; j < MN; ++j)
      pv[j] = p[(size_t)(j / NTC) * chi * ldp + (size_t)(j % NTC) * chi];
    for (int k = 1; k < K3; ++k)
#pragma unroll
      for (int j = 0; j < MN; ++j)
        pv[j] += p[k * slot + (size_t)(j / NTC) * chi * ldp +
                   (size_t)(j % NTC) * chi];
#pragma unroll
    for (int j = 0; j < MN; ++j)
#pragma unroll
      for (int i = 0; i < MN; ++i) q[i] += cs[j * MN + i] * pv[j];
  } else {
    for (int w = 0; w < M; ++w)
      for (int t = 0; t < nt; ++t) {
        const size_t off = (size_t)w * chi * ldp + (size_t)t * chi;
        float pv = p[off];
        for (int k = 1; k < K3; ++k) pv += p[k * slot + off];
        const float* cw = cs + (w * nt + t) * mn;
#pragma unroll
        for (int i = 0; i < MAX_MN; ++i)
          if (i < mn) q[i] += cw[i] * pv;
      }
  }
#pragma unroll
  for (int i = 0; i < MAX_MN; ++i)
    if (i < mn) out[(i % nt) * chi * ldq + (i / nt) * chi] = q[i];
}

// Stage 2: one block per (s, output tile) in blockIdx.x and instance in
// blockIdx.y; with DOT, part[b][blockIdx.x] = the tile's <x, y>, summed
// in a fixed order (without, x and part are not read).
template <int BM, int BN, bool FINE = false, bool DOT = true>
__global__ void __launch_bounds__(THREADS, min_blocks<BM, BN>())
    stage2_kernel(const float* __restrict__ Q, const float* __restrict__ Rt,
                  const float* __restrict__ x, float* __restrict__ y,
                  float* __restrict__ part, int chi, int nt, int M, int vec) {
  using T = Tile<BM, BN>;
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const size_t plane = (size_t)chi * chi;
  const int nrb = (chi + BM - 1) / BM, ncb = (chi + BN - 1) / BN;
  const int s = blockIdx.x / (nrb * ncb), tile = blockIdx.x % (nrb * ncb);
  const int r0 = (tile / ncb) * BM, c0 = (tile % ncb) * BN;
  const size_t b = blockIdx.y;
  const int ldq = M * chi;
  const int rows = chi - r0, cols = chi - c0;
  float acc[T::MT][T::NT][4] = {};
  gemm_tile<BM, BN, FINE>(acc, Q + ((b * nt + s) * chi + r0) * (size_t)ldq,
                          ldq, Rt + b * M * plane + c0, chi, ldq, rows, cols,
                          vec != 0, smem);
  const size_t off = (b * nt + s) * plane + (size_t)r0 * chi + c0;
  float dot = 0.f;
  for_each_acc<BM, BN>(acc, [&](int r, int c, float v) {
    if (r < rows && c < cols) {
      y[off + (size_t)r * chi + c] = v;
      if constexpr (DOT) dot += x[off + (size_t)r * chi + c] * v;
    }
  });
  if constexpr (!DOT) return;
  dot = heff::warp_sum(dot);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) smem[warp] = dot;  // the ring is free (gemm_tile's sync)
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) sum += smem[i];
    part[b * gridDim.x + blockIdx.x] = sum;
  }
}

template <int BM, int BN, bool FINE = false>
cudaError_t launch_stage1(const float* Lt, const float* x, float* P, int B,
                          int chi, int nt, int M, int K3, bool vec,
                          cudaStream_t stream) {
  using T = Tile<BM, BN>;
  auto kern = stage1_kernel<BM, BN, FINE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = ((M * chi + BM - 1) / BM) * nt * ((chi + BN - 1) / BN);
  kern<<<dim3(blocks, B * K3), THREADS, T::SMEM, stream>>>(Lt, x, P, chi, nt,
                                                           M, K3, vec);
  return cudaGetLastError();
}

template <int BM, int BN, bool FINE = false, bool DOT = true>
cudaError_t launch_stage2(const float* Q, const float* Rt, const float* x,
                          float* y, float* part, int B, int chi, int nt,
                          int M, bool vec, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  auto kern = stage2_kernel<BM, BN, FINE, DOT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = nt * ((chi + BM - 1) / BM) * ((chi + BN - 1) / BN);
  kern<<<dim3(blocks, B), THREADS, T::SMEM, stream>>>(Q, Rt, x, y, part, chi,
                                                      nt, M, vec);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The fold pass: one thread per (c, b) of each instance; M=3 with nt=2
// or 4 at compile time.
inline cudaError_t launch_fold(const float* C, long long c_stride,
                               const float* P, float* Q, int B, int chi,
                               int nt, int M, int K3, cudaStream_t stream) {
  const size_t plane = (size_t)chi * chi;
  const dim3 fgrid((unsigned)((plane + FOLD_THREADS - 1) / FOLD_THREADS), B);
  if (M == 3 && nt == 2)
    fold_kernel<3, 2><<<fgrid, FOLD_THREADS, 0, stream>>>(C, c_stride, P, Q,
                                                          chi, nt, M, K3);
  else if (M == 3 && nt == 4)
    fold_kernel<3, 4><<<fgrid, FOLD_THREADS, 0, stream>>>(C, c_stride, P, Q,
                                                          chi, nt, M, K3);
  else
    fold_kernel<0, 0><<<fgrid, FOLD_THREADS, 0, stream>>>(C, c_stride, P, Q,
                                                          chi, nt, M, K3);
  return cudaGetLastError();
}

// The whole f32 matvec: stage 1, the fold, stage 2 and the ordered sum of
// the <x, y> slots, on `stream`.  Scratch P: B*K3*M*nt*chi^2 words, Q:
// B*M*nt*chi^2; part: B * (stage-2 blocks of tile2).  tile1, tile2: the
// TileCode of each GEMM stage.  Returns the first launch error.
inline int launch_matvec(const float* C, long long c_stride, const float* Lt,
                         const float* Rt, const float* x, float* P, float* Q,
                         float* y, float* part, float* alpha, int B, int chi,
                         int nt, int M, int K3, int tile1, int tile2,
                         cudaStream_t stream) {
  if (K3 < 1 || chi % K3 || M * nt > MAX_MN || B < 1 || B > 65535 ||
      tile1 < 0 || tile1 > 2 || tile2 < 0 || tile2 > 2)
    return (int)cudaErrorInvalidValue;
  const bool base = aligned16(Lt) && aligned16(Rt) && aligned16(x) &&
                    aligned16(Q);
  const bool vec2 = base && chi % 4 == 0;
  const bool vec1 = vec2 && (chi / K3) % 4 == 0;
  cudaError_t err;
  switch (tile1) {
    case T128x128:
      err = launch_stage1<128, 128>(Lt, x, P, B, chi, nt, M, K3, vec1, stream);
      break;
    case T128x64:
      err = launch_stage1<128, 64>(Lt, x, P, B, chi, nt, M, K3, vec1, stream);
      break;
    default:
      err = launch_stage1<64, 64>(Lt, x, P, B, chi, nt, M, K3, vec1, stream);
  }
  if (err != cudaSuccess) return (int)err;
  err = launch_fold(C, c_stride, P, Q, B, chi, nt, M, K3, stream);
  if (err != cudaSuccess) return (int)err;
  int bm, bn;
  switch (tile2) {
    case T128x128:
      bm = 128, bn = 128;
      err = launch_stage2<128, 128>(Q, Rt, x, y, part, B, chi, nt, M, vec2,
                                    stream);
      break;
    case T128x64:
      bm = 128, bn = 64;
      err = launch_stage2<128, 64>(Q, Rt, x, y, part, B, chi, nt, M, vec2,
                                   stream);
      break;
    default:
      bm = 64, bn = 64;
      err = launch_stage2<64, 64>(Q, Rt, x, y, part, B, chi, nt, M, vec2,
                                  stream);
  }
  if (err != cudaSuccess) return (int)err;
  const int slots = nt * ((chi + bm - 1) / bm) * ((chi + bn - 1) / bn);
  heff::ordered_sum_kernel<float><<<B, heff::THREADS, 0, stream>>>(
      part, slots, alpha);
  return (int)cudaGetLastError();
}

}  // namespace tc32
