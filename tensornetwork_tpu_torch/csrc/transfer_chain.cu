// Batched MPS transfer chain: for each instance
//   E <- sum_{a,c,s} E[a,c] A_n[a,s,b] A_n[c,s,p]
// over all N sites.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_transfer_chain (the
// function that reaches its pallas_call); one function for its "loop",
// "rows" and "dg" variants, which differ only in the TPU program's layout.
//
// Rounding points (kernels.py make_transfer_chain): E is carried in f32;
// at every site it is cast to the input type T before stage 1,
//   Y[c][s][b] = sum_a T(E)[a][c] A_n[a][s][b]      (f32 sums, Y cast to T)
//   E'[b][p]   = sum_{c,s} Y[c][s][b] A_n[c][s][p]  (f32 sums)
// and E_N is returned in f32.  T is __nv_bfloat16 or float.
//
// Two GEMMs per site, no reshuffle: the site tensor in its solver layout
// [a][s][b] is both operands.  Stage 1 is Y = T(E)^T A_n with A_n read as
// a row-major chi x (d chi) matrix (columns (s, b)), one GEMM of depth
// chi.  Stage 2 is E' = Y_v^T A_v with Y [c][s][b] and A_n [a][s][b] both
// read as row-major (d chi) x chi matrices (rows (c, s)), one GEMM of
// depth d chi.  Both take a transposed A operand, C[m][n] = sum_k X[k][m]
// Z[k][n]: for bf16, ldmatrix.trans serves mma.sync m16n8k16 straight
// from the k-major tiles.
//
// What bounds it on the H100: at the bench shape (B=256, N=32, chi=128,
// d=2, bf16) an application reads 537 MB of site tensors and does 137
// GFLOP, 0.160 ms of device memory against 0.139 ms of bf16 tensor-core
// work: bytes, just.  The products of two bf16 values are exact in the
// tensor cores' f32 accumulators, so the bf16 kernels compute the
// function of a fp32 kernel on widened operands up to summation order.
//
// Route "resident" (bf16, while (1 + 3d) chi^2 elements fit one block's
// 227 KB; d=2 chi<=128, the bench shape): one block per instance walks
// its N sites, as the TPU kernel keeps E in VMEM across its sequential
// site axis.  Shared memory, bf16, rows of chi elements:
//   sE  [a][c]        chi^2     T(E), then the next site's T(E')
//   sA0, sA1 [a][s][b] d chi^2 each: the site tensor, double-buffered;
//                     site n+1 is fetched by 16-byte cp.async.cg while
//                     site n computes
//   sY  [c][s][b]     d chi^2   stage 1's output, rounded to bf16
// (224 KB at chi=128, d=2: no room to pad the rows).  The 16-byte chunks
// of a row are XOR-swizzled, chunk j of row R at j ^ ((R + R/8) & mask),
// so that the eight row addresses of an ldmatrix phase hit distinct
// banks both for consecutive rows (stage 2, and stage 1's E) and for
// rows d apart (stage 1's A at d = 2 and 4).  16 warps walk 64 x 16 warp
// tiles (4 x 2 m16n8 fragments, 32 f32 accumulators a thread) of each
// stage's output, a stage-1 tile within one s; each lane steps its
// ldmatrix addresses and swizzle keys incrementally and loads the
// fragments of the next 16-deep step before issuing the current step's
// mmas.  Stage 2 writes T(E') into sE, or at the last site E_N in f32 to
// device memory.  Each output element is summed by one thread in a fixed
// order: no atomics, a second launch gives the same bits.  The 256
// instances of the bench shape run in two waves on 132 SMs (one 224 KB
// block per SM).
//
// Route "tiled" (everything else: any chi in bf16, d beyond the budget,
// and every f32 chain): per site, two batched GEMM launches over the
// whole batch, stage 1 and stage 2, with T(E) and Y in device memory
// (at B=16, chi=256 they stay in the 50 MB L2) and the stream ordering
// the sites.  No work is duplicated across blocks.  bf16: 128 x 128
// block tiles of 8 warps on 64 x 32 warp tiles of the same fragments,
// the k-major operands staged 32 deep through a 3-stage cp.async ring of
// swizzled tiles.  f32: heff.cuh's fp32 SIMT tile GEMM (64 x 64 tiles, fp32
// products, as the twin's highest precision requires), read transposed;
// the fp32 SIMT rate (67 TFLOP/s) bounds it.
//
// The bf16 kernels take chi % 16 == 0 (the m16n8k16 fragment); the
// wrapper pads chi with zeros, which leaves every sum unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "heff.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;     // 8 warps
constexpr int WM = 4, WN = 4;    // tiled warp tile: 4 m16 x 4 n8 fragments
// the resident route's block: 16 warps on 64 x 16 warp tiles (4 m16 x 2
// n8 fragments), of six block shapes tried (256 or 512 threads, 32-64 x
// 16-64 warp tiles) the fastest at the bench shape on an H100 80GB HBM3
// at 700 W
constexpr int RTHREADS = 512, RFM = 4, RFN = 2;
constexpr int RTM = 16 * RFM, RTN = 8 * RFN;  // resident warp tile
constexpr int GRAN = 16;         // chi granularity of the bf16 kernels
constexpr int TBM = 128, TBN = 128, TBK = 32, TSTAGES = 3;  // tiled ring
static_assert(TBM / 8 % 8 == 0 && TBN / 8 % 8 == 0, "ring rows: mask 7");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; `bytes` = 0 zero-fills
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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

// four 8x8 b16 matrices at shared address `addr`, transposed on the way
// to the registers
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) @ b (16x8, col), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the XOR mask of rows of `rl` elements: the largest power of two that
// divides the 16-byte chunks of a row, at most 8, less one
__host__ __device__ inline int chunk_mask(int rl) {
  const int cpr = rl / 8;
  return (cpr & 7) == 0 ? 7 : (cpr & 3) == 0 ? 3 : (cpr & 1) == 0 ? 1 : 0;
}

// A bf16 matrix in shared memory: rows of `rl` elements, chunk j of row R
// stored at chunk j ^ ((R + R/8) & mask).
struct SmemMat {
  bf16* p;
  int rl, mask;
  __device__ __forceinline__ int off(int R, int col) const {
    return R * rl + ((((col >> 3) ^ ((R + (R >> 3)) & mask))) << 3) +
           (col & 7);
  }
  __device__ __forceinline__ bf16* at(int R, int col) const {
    return p + off(R, col);
  }
};

// acc[i][j] += the warp's (16 FM) x (8 FN) tile at (m0, n0) of C = X^T Z
// over k in [0, K) (K % 16 == 0): X(k, m) is row k, column m of X;
// Z(k, n) is row k*zsegs + n/Z.rl, column n % Z.rl of Z (zsegs = d
// reads the site tensor [a][s][b] as a chi x (d chi) matrix).  mt m16
// fragments and np n16 pairs of the tile are inside the output
// (warp-uniform).  Each lane keeps its ldmatrix row addresses and
// swizzle keys and steps them by 16 rows: R -> R + 16 z moves the key
// (R + R/8) by 18 z.  The fragments of step k+16 are loaded before the
// mmas of step k are issued.
template <int FM, int FN>
__device__ __forceinline__ void warp_tile(float (&acc)[FM][FN][4],
                                          const SmemMat& X, const SmemMat& Z,
                                          int zsegs, int m0, int n0, int K,
                                          int mt, int np) {
  constexpr int FP = FN / 2;  // n16 pairs
  const int lane = threadIdx.x & 31;
  // ldmatrix row providers: A fragments (k, m) blocks (0,0) (0,8) (8,0)
  // (8,8); B fragments (k, n) blocks (0,0) (8,0) (0,8) (8,8)
  const int xk = (lane & 7) + ((lane >> 4) << 3), xm = ((lane >> 3) & 1) << 3;
  const int zk = (lane & 7) + (((lane >> 3) & 1) << 3), zn = (lane >> 4) << 3;
  const uint32_t xb = smem_u32(X.p), zb = smem_u32(Z.p);
  int xrow = xk * X.rl, xkey = (xk + (xk >> 3)) & X.mask;
  int xc[FM];
#pragma unroll
  for (int i = 0; i < FM; ++i) xc[i] = (m0 + i * 16 + xm) >> 3;
  int zrow[FP], zkey[FP], zc[FP];
#pragma unroll
  for (int j = 0; j < FP; ++j) {
    const int n = n0 + j * 16 + zn, seg = n / Z.rl;
    const int R = zk * zsegs + seg;
    zrow[j] = R * Z.rl;
    zkey[j] = (R + (R >> 3)) & Z.mask;
    zc[j] = (n - seg * Z.rl) >> 3;
  }
  const int xstep = 16 * X.rl, zstep = 16 * zsegs * Z.rl, zks = 18 * zsegs;
  uint32_t a[2][FM][4], b[2][FP][4];
  auto load = [&](int buf) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
      if (i < mt)
        ldsm_x4_t(a[buf][i], xb + 2 * (xrow + ((xc[i] ^ xkey) << 3)));
#pragma unroll
    for (int j = 0; j < FP; ++j)
      if (j < np)
        ldsm_x4_t(b[buf][j], zb + 2 * (zrow[j] + ((zc[j] ^ zkey[j]) << 3)));
    xrow += xstep;
    xkey = (xkey + 18) & X.mask;
#pragma unroll
    for (int j = 0; j < FP; ++j) {
      zrow[j] += zstep;
      zkey[j] = (zkey[j] + zks) & Z.mask;
    }
  };
  auto mma = [&](int buf) {
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      if (i >= mt) continue;
#pragma unroll
      for (int j = 0; j < FP; ++j) {
        if (j >= np) continue;
        mma_bf16(acc[i][2 * j], a[buf][i], b[buf][j][0], b[buf][j][1]);
        mma_bf16(acc[i][2 * j + 1], a[buf][i], b[buf][j][2], b[buf][j][3]);
      }
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += 32) {
    const bool two = k0 + 16 < K;
    if (two) load(1);
    mma(0);
    if (k0 + 32 < K) load(0);
    if (two) mma(1);
  }
}

template <int FM, int FN>
__device__ __forceinline__ void zero(float (&acc)[FM][FN][4]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// f(row, col, v0, v1) for each pair of neighbouring outputs (col even)
// of the warp's tile at (m0, n0)
template <int FM, int FN, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[FM][FN][4],
                                              int m0, int n0, int mt, int np,
                                              F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
    if (i >= mt) continue;
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      if (j >= 2 * np) continue;
      const int r = m0 + i * 16 + g, c = n0 + j * 8 + 2 * q;
      f(r, c, acc[i][j][0], acc[i][j][1]);
      f(r + 8, c, acc[i][j][2], acc[i][j][3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Route "resident"
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t resident_smem_bytes(int chi, int d) {
  return (size_t)(1 + 3 * d) * chi * chi * sizeof(bf16);
}

// the site tensor (d chi rows of chi elements) into swizzled shared memory
__device__ __forceinline__ void fetch_site(const SmemMat& dst, const bf16* src,
                                           int rows) {
  const int cpr = dst.rl / 8;
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int R = e / cpr, j = e - R * cpr;
    cp16(dst.at(R, j * 8), src + (size_t)R * dst.rl + j * 8, 16);
  }
}

// One stage of the resident route: C = X^T Z, chi rows and segs column
// segments of chi (a warp tile lies within one segment), depth K, by the
// block's warps over RTM x RTN warp tiles; f(r, s, col, v0, v1) stores
// the outputs (r, s*chi + col) and (r, s*chi + col + 1).
template <typename F>
__device__ __forceinline__ void resident_gemm(const SmemMat& X,
                                              const SmemMat& Z, int zsegs,
                                              int chi, int segs, int K, F f) {
  const int warp = threadIdx.x / 32;
  const int mb = (chi + RTM - 1) / RTM, nb = (chi + RTN - 1) / RTN;
  for (int job = warp; job < mb * segs * nb; job += RTHREADS / 32) {
    const int m0 = (job / (segs * nb)) * RTM, s = (job / nb) % segs;
    const int c0 = (job % nb) * RTN;
    const int mt = min(RFM, (chi - m0) / 16);
    const int np = min(RFN / 2, (chi - c0) / 16);
    float acc[RFM][RFN][4];
    zero(acc);
    warp_tile(acc, X, Z, zsegs, m0, s * chi + c0, K, mt, np);
    for_each_pair(acc, m0, c0, mt, np,
                  [&](int r, int c, float v0, float v1) { f(r, s, c, v0, v1); });
  }
}

__global__ void __launch_bounds__(RTHREADS, 1)
    chain_resident_kernel(const bf16* __restrict__ As,
                          const float* __restrict__ E0,
                          float* __restrict__ out, int N, int chi, int d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int mask = chunk_mask(chi);
  bf16* base = reinterpret_cast<bf16*>(smem_raw);
  const size_t plane = (size_t)chi * chi, site = d * plane;
  const SmemMat sE{base, chi, mask};
  const SmemMat sY{base + plane + 2 * site, chi, mask};
  const size_t b = blockIdx.x;
  As += b * N * site;
  const int dchi = d * chi;

  fetch_site(SmemMat{base + plane, chi, mask}, As, dchi);
  cp_commit();
  for (int e = threadIdx.x; e < chi * chi; e += RTHREADS) {
    const int a = e / chi, c = e - a * chi;
    *sE.at(a, c) = __float2bfloat16_rn(E0[b * plane + e]);
  }

  for (int n = 0; n < N; ++n) {
    const SmemMat A{base + plane + (n & 1) * site, chi, mask};
    if (n + 1 < N)
      fetch_site(SmemMat{base + plane + ((n + 1) & 1) * site, chi, mask},
                 As + (n + 1) * site, dchi);
    cp_commit();
    cp_wait<1>();     // this thread's copies of site n have landed
    __syncthreads();  // everyone's; T(E) complete; sY free

    // stage 1: Y[c][(s,b)] = sum_a E[a][c] A[a][(s,b)]
    resident_gemm(sE, A, d, chi, d, chi,
                  [&](int r, int s, int col, float v0, float v1) {
                    *reinterpret_cast<uint32_t*>(sY.at(r * d + s, col)) =
                        pack_bf16(v0, v1);
                  });
    __syncthreads();  // Y complete; T(E) no longer read

    // stage 2: E'[b][p] = sum_{(c,s)} Y[(c,s)][b] A[(c,s)][p]
    if (n == N - 1) {
      float* o = out + b * plane;
      resident_gemm(sY, A, 1, chi, 1, dchi,
                    [&](int r, int, int c, float v0, float v1) {
                      *reinterpret_cast<float2*>(o + (size_t)r * chi + c) =
                          make_float2(v0, v1);
                    });
    } else {
      resident_gemm(sY, A, 1, chi, 1, dchi,
                    [&](int r, int, int c, float v0, float v1) {
                      *reinterpret_cast<uint32_t*>(sE.at(r, c)) =
                          pack_bf16(v0, v1);
                    });
    }
    __syncthreads();  // stage 2 done with A and Y before they are refilled
  }
}

int launch_resident(const bf16* As, const float* E0, float* out, int B, int N,
                    int chi, int d, cudaStream_t stream) {
  if (chi < GRAN || chi % GRAN || N < 1 || d < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = resident_smem_bytes(chi, d);
  cudaError_t err = cudaFuncSetAttribute(
      chain_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  chain_resident_kernel<<<B, RTHREADS, bytes, stream>>>(As, E0, out, N, chi,
                                                        d);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route "tiled": one batched GEMM C = X^T Z per stage and site
// ---------------------------------------------------------------------------

// X (K x M, row-major, ldx), Z (K x Nn, ldz), C (M x Nn, ldc), one of
// each per instance (blockIdx.y) at the given strides.
struct Gemm {
  const void* X;
  const void* Z;
  void* C;
  int ldx, ldz, ldc;
  long long xs, zs, cs;
  int M, Nn, K;
};

constexpr int TILED_SMEM = TSTAGES * (TBK * TBM + TBK * TBN) * sizeof(bf16);

// one ring stage: rows k0..k0+TBK of X (columns m0..) and Z (columns n0..),
// zero past K, M and Nn (all multiples of 16: a chunk is in or out)
__device__ __forceinline__ void tiled_stage(const SmemMat& Xs,
                                            const SmemMat& Zs,
                                            const bf16* X, const bf16* Z,
                                            const Gemm& g, int m0, int n0,
                                            int k0) {
  constexpr int CX = TBM / 8, CZ = TBN / 8;
  for (int e = threadIdx.x; e < TBK * (CX + CZ); e += blockDim.x) {
    if (e < TBK * CX) {
      const int k = e / CX, m = (e % CX) * 8;
      const bool in = k0 + k < g.K && m0 + m < g.M;
      cp16(Xs.at(k, m), in ? X + (size_t)(k0 + k) * g.ldx + m0 + m : X,
           in ? 16 : 0);
    } else {
      const int f = e - TBK * CX, k = f / CZ, n = (f % CZ) * 8;
      const bool in = k0 + k < g.K && n0 + n < g.Nn;
      cp16(Zs.at(k, n), in ? Z + (size_t)(k0 + k) * g.ldz + n0 + n : Z,
           in ? 16 : 0);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    chain_tiled_bf16_kernel(Gemm g, int out_f32) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* base = reinterpret_cast<bf16*>(smem_raw);
  const int ncb = (g.Nn + TBN - 1) / TBN;
  const int m0 = (blockIdx.x / ncb) * TBM, n0 = (blockIdx.x % ncb) * TBN;
  const size_t b = blockIdx.y;
  const bf16* X = static_cast<const bf16*>(g.X) + b * g.xs;
  const bf16* Z = static_cast<const bf16*>(g.Z) + b * g.zs;
  // ring stage s: X rows at base + s TBK TBM, Z rows after all X stages
  auto xs = [&](int s) { return SmemMat{base + s * TBK * TBM, TBM, 7}; };
  auto zs = [&](int s) {
    return SmemMat{base + (TSTAGES * TBM + s * TBN) * TBK, TBN, 7};
  };
  const int warp = threadIdx.x / 32;
  const int wm0 = m0 + (warp / 4) * 64, wn0 = n0 + (warp % 4) * 32;
  const int mt = max(0, min(WM, (g.M - wm0) / 16));
  const int np = max(0, min(WN / 2, (g.Nn - wn0) / 16));
  const int nk = (g.K + TBK - 1) / TBK;
#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < nk) tiled_stage(xs(s), zs(s), X, Z, g, m0, n0, s * TBK);
    cp_commit();
  }
  float acc[WM][WN][4];
  zero(acc);
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<TSTAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();         // ... everyone's; stage kt-1 is free
    const int nxt = kt + TSTAGES - 1;
    if (nxt < nk)
      tiled_stage(xs(nxt % TSTAGES), zs(nxt % TSTAGES), X, Z, g, m0, n0,
                  nxt * TBK);
    cp_commit();
    // the ring's zero rows past K add exact zeros
    if (mt > 0 && np > 0)
      warp_tile(acc, xs(kt % TSTAGES), zs(kt % TSTAGES), 1, wm0 - m0,
                wn0 - n0, TBK, mt, np);
  }
  cp_wait<0>();
  if (mt <= 0 || np <= 0) return;
  if (out_f32) {
    float* C = static_cast<float*>(g.C) + b * g.cs;
    for_each_pair(acc, wm0, wn0, mt, np, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(C + (size_t)r * g.ldc + c) = make_float2(v0, v1);
    });
  } else {
    bf16* C = static_cast<bf16*>(g.C) + b * g.cs;
    for_each_pair(acc, wm0, wn0, mt, np, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<uint32_t*>(C + (size_t)r * g.ldc + c) = pack_bf16(v0, v1);
    });
  }
}

// f32: heff.cuh's SIMT tile GEMM with X read transposed
struct LoadTrans {
  const float* X;
  int ld;
  __device__ float operator()(int r, int k) const {
    return X[(size_t)k * ld + r];
  }
};

__global__ void __launch_bounds__(heff::THREADS)
    chain_tiled_f32_kernel(Gemm g) {
  __shared__ heff::Smem<float> sm;
  const int ncb = (g.Nn + heff::TILE - 1) / heff::TILE;
  const int r0 = (blockIdx.x / ncb) * heff::TILE;
  const int c0 = (blockIdx.x % ncb) * heff::TILE;
  const size_t b = blockIdx.y;
  float acc[heff::SUB][heff::SUB];
  heff::zero_acc(acc);
  LoadTrans aload{static_cast<const float*>(g.X) + b * g.xs, g.ldx};
  heff::tile_gemm(acc, aload, static_cast<const float*>(g.Z) + b * g.zs,
                  g.ldz, g.K, g.M, g.Nn, r0, c0, sm);
  heff::store_tile(acc, static_cast<float*>(g.C) + b * g.cs, g.ldc, g.M,
                   g.Nn, r0, c0);
}

template <typename T>
cudaError_t launch_gemm(const Gemm& g, int B, bool out_f32,
                        cudaStream_t stream);

template <>
cudaError_t launch_gemm<bf16>(const Gemm& g, int B, bool out_f32,
                              cudaStream_t stream) {
  const dim3 grid(((g.M + TBM - 1) / TBM) * ((g.Nn + TBN - 1) / TBN), B);
  chain_tiled_bf16_kernel<<<grid, THREADS, TILED_SMEM, stream>>>(g, out_f32);
  return cudaGetLastError();
}

template <>
cudaError_t launch_gemm<float>(const Gemm& g, int B, bool,
                               cudaStream_t stream) {
  const int nt = heff::TILE;
  const dim3 grid(((g.M + nt - 1) / nt) * ((g.Nn + nt - 1) / nt), B);
  chain_tiled_f32_kernel<<<grid, heff::THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}

// the chain: per site stage 1 (Y = T(E)^T A_n into Ybuf) and stage 2
// (E' = Y_v^T A_v into Ebuf as T, or at the last site into out as f32)
template <typename T>
int launch_tiled(const T* As, const T* E0, T* Ebuf, T* Ybuf, float* out,
                 int B, int N, int chi, int d, cudaStream_t stream) {
  const bool is_bf16 = sizeof(T) == 2;
  if (chi < 1 || N < 1 || d < 1 || B < 1 || B > 65535 ||
      (is_bf16 && chi % GRAN))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        chain_tiled_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TILED_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const long long plane = (long long)chi * chi, site = d * plane;
  const int dchi = d * chi;
  for (int n = 0; n < N; ++n) {
    const T* An = As + n * site;
    const T* E = n == 0 ? E0 : Ebuf;
    // stage 1: X = T(E) [a][c], Z = A_n as chi x (d chi), C = Y [c][(s,b)]
    Gemm g1{E, An, Ybuf, chi, dchi, dchi, plane, N * site, site,
            chi, dchi, chi};
    cudaError_t err = launch_gemm<T>(g1, B, false, stream);
    if (err != cudaSuccess) return (int)err;
    // stage 2: X = Y as (d chi) x chi, Z = A_n as (d chi) x chi
    const bool last = n == N - 1;
    Gemm g2{Ybuf, An, last ? (void*)out : (void*)Ebuf, chi, chi, chi, site,
            N * site, plane, chi, chi, dchi};
    err = launch_gemm<T>(g2, B, last, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// As: (B,N,chi,d,chi) in the input type T (the solver layout; bf16:
// chi % 16 == 0); E0: (B,chi,chi) f32; out: (B,chi,chi) f32.  tiled = 0:
// route "resident" (bf16 only, (1+3d) chi^2 elements within one block's
// shared memory), one launch; E0t, Ebuf, Ybuf unused.  tiled = 1: route
// "tiled", 2N launches; E0t (B,chi,chi) T(E0) and scratch Ebuf
// (B,chi,chi), Ybuf (B,chi,d,chi) in T.  Returns the first launch error.
extern "C" int tn_transfer_chain_bf16(const void* As, const float* E0,
                                      const void* E0t, void* Ebuf, void* Ybuf,
                                      float* out, int B, int N, int chi, int d,
                                      int tiled, void* stream) {
  if (!tiled)
    return launch_resident(static_cast<const bf16*>(As), E0, out, B, N, chi,
                           d, (cudaStream_t)stream);
  return launch_tiled<bf16>(
      static_cast<const bf16*>(As), static_cast<const bf16*>(E0t),
      static_cast<bf16*>(Ebuf), static_cast<bf16*>(Ybuf), out, B, N, chi, d,
      (cudaStream_t)stream);
}

extern "C" int tn_transfer_chain_f32(const void* As, const float*,
                                     const void* E0t, void* Ebuf, void* Ybuf,
                                     float* out, int B, int N, int chi, int d,
                                     int tiled, void* stream) {
  if (!tiled) return (int)cudaErrorInvalidValue;  // f32 is tiled only
  return launch_tiled<float>(
      static_cast<const float*>(As), static_cast<const float*>(E0t),
      static_cast<float*>(Ebuf), static_cast<float*>(Ybuf), out, B, N, chi,
      d, (cudaStream_t)stream);
}
