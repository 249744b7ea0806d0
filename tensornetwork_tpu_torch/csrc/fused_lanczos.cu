// Whole-Lanczos-step kernel: all m H_eff matvecs of one site's local
// eigensolve and the three-term recurrence, one block per instance.
//
// Replaces: tensornetwork_tpu/ops/kernels.py make_fused_lanczos (the
// function that reaches its pallas_call), at tile_b = 1.
//
// Semantics (kernels.py make_fused_lanczos, krylov.lanczos_factorization
// with reorthogonalize=False): v0 = x0/|x0| (zero and dead when
// |x0| <= delta); per step j: V[j] = v; w = H v; alpha = <v,w>;
// w -= alpha v + beta_prev v_prev; beta = |w|; a dead step stores the
// +1e10 alpha sentinel, a zero beta and a zero next vector.
//
// What bounds it on the H100: operations.  m matvecs of 4*M*nt*chi^3
// flops (63 MFLOP per instance at chi=64, M=3, nt=2, m=10) against L, R,
// x in and V out, ~140 flops per byte in fp32.  The fp32 SIMT rate (67
// TFLOP/s) bounds a SIMT kernel; fp32-accurate products on the tensor
// cores by 3xTF32 are bounded by 3 x flops at 495 TFLOP/s, 2.5x less.
//
// Design, f32: the matvec of the f32 streamed matvecs (gemm_tc32.cuh, K7)
// inside one block per instance, on its 3xTF32 mma.sync core:
//   stage 1  P[(w,c)][(t,b)] = sum_a Lt[w][c][a] v[t][a][b], one
//            (M chi) x (nt chi) GEMM of depth chi, in 64 x 64 tiles;
//   fold     Q[(v,c)][(s,b)] = sum_{w,t} C[w,v,s,t] P[(w,c)][(t,b)], once
//            per element, in place: Q takes P's positions, so each thread
//            reads the M nt values of its (c, b) and writes its M nt
//            results where they were (M=3, nt=2 or 4 fixed at compile
//            time, so all loads of an element are in flight at once);
//   stage 2  w_s = sum_v Q[(v,.)][(s,.)] Rt_v, per 64 x 64 output tile
//            M chi deep (v major), <v, w> summed in the tile epilogue.
// The tiles of a stage are one stream of 32-deep stages through
// gemm_tc32.cuh's 3-stage cp.async ring (55 KB of dynamic shared memory),
// which runs on from one tile to the next, so the copies of the next
// tile land while the current one computes; the scratch P/Q
// (M nt chi^2), w and the basis V live in device memory and are read
// back by the block that wrote them, mostly from the 50 MB L2.  Nothing
// but the ring, the couplings and the reduction slots is kept on chip:
// at chi=64, nt=2 the pieces (v, w 32 KB each, P 96 KB, Lt, Rt 48 KB
// each) exceed one block's 227 KB, and a block that held them would run
// alone on its SM, where two blocks of 55 KB rings (128 registers a
// thread) take all 256 instances of the batch in one wave on 132 SMs and
// hide each other's copy latency.  The products: big/small split by
// integer ops, mma m16n8k8, the small terms of a 32-deep stage summed
// from zero and each 8-deep big x big product from zero, each added in
// f32 (gemm_tc32.cuh stage_mma<FINE>: <v, H v> sums the outputs, so the
// tensor cores' round-toward-zero, which shrinks them all alike, would
// survive in alpha; with K7's 12-mma stage sums alpha read 6.8x the f32
// twin's error against f64, on an H100 80GB HBM3 at 700 W); values of
// <= 22 significant bits split exactly, so small-integer operators give
// exact products (the breakdown chains equal the twin's bits).  <v, w>,
// |w| and |x0| sum exact f32 products in f64, each thread's share then a
// block tree in a fixed order, rounded to f32 once, so that 32-term
// sequential f32 partials add no error of their own.  No float atomics:
// a repeat launch gives the same bits.
//
// f64 keeps the SIMT core of heff.cuh: P and w in device memory, the
// couplings folded while stage 2's A operand is staged (heff::LoadQ),
// one 64x64 tile of 256 threads at a time.
#include "gemm_tc32.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(heff::THREADS)
    fused_lanczos_kernel(const T* __restrict__ W, long long w_stride,
                         const T* __restrict__ Lt, const T* __restrict__ Rt,
                         const T* __restrict__ x0, T* __restrict__ V,
                         T* __restrict__ ab, T* __restrict__ Pbuf,
                         T* __restrict__ wbuf, int chi, int d, int M, int m,
                         T delta) {
  __shared__ heff::Smem<T> sm;
  const T LARGE = T(1e10);
  const size_t plane = (size_t)chi * chi;
  const size_t n = d * plane;
  const size_t b = blockIdx.x;
  const int nt = heff::num_tiles(chi);
  const int tid = threadIdx.x;

  Lt += b * M * plane;
  Rt += b * M * plane;
  x0 += b * n;
  V += b * (size_t)m * n;
  ab += b * 2 * m;
  T* P = Pbuf + b * M * d * plane;
  T* w = wbuf + b * n;
  heff::load_couplings(W + b * w_stride, d, M, sm);

  T part = T(0);
  for (size_t e = tid; e < n; e += blockDim.x) part += x0[e] * x0[e];
  const T nrm = sqrt(heff::block_sum(part, sm));
  bool alive = nrm > delta;
  T inv = alive ? T(1) / nrm : T(0);
  for (size_t e = tid; e < n; e += blockDim.x) V[e] = x0[e] * inv;
  T beta_prev = T(0);

  for (int j = 0; j < m; ++j) {
    __syncthreads();  // V[j] is complete
    const T* v = V + j * n;
    const T* vp = j > 0 ? V + (j - 1) * n : v;  // read only when j > 0
    for (int job = 0; job < M * d * nt * nt; ++job)
      heff::stage1_tile(job, Lt, v, P, chi, d, sm);
    __syncthreads();  // every P plane is complete
    for (int job = 0; job < d * nt * nt; ++job)
      heff::stage2_tile(job, Rt, P, w, chi, d, M, sm);
    __syncthreads();  // w = H v is complete

    part = T(0);
    for (size_t e = tid; e < n; e += blockDim.x) part += v[e] * w[e];
    const T alpha = heff::block_sum(part, sm);
    if (tid == 0) ab[j] = alive ? alpha : LARGE;

    // each thread updates, and later rescales, only its own elements
    part = T(0);
    for (size_t e = tid; e < n; e += blockDim.x) {
      T we = w[e] - alpha * v[e];
      if (j > 0) we -= beta_prev * vp[e];
      w[e] = we;
      part += we * we;
    }
    const T beta = sqrt(heff::block_sum(part, sm));
    const bool alive_next = alive && beta > delta;
    if (j < m - 1) {
      if (tid == 0) ab[m + j] = alive_next ? beta : T(0);
      inv = beta > delta ? T(1) / beta : T(0);
      const T keep = alive_next ? T(1) : T(0);
      T* vn = V + (j + 1) * n;
      for (size_t e = tid; e < n; e += blockDim.x) vn[e] = w[e] * inv * keep;
    }
    beta_prev = alive_next ? beta : T(0);
    alive = alive_next;
  }
  if (tid == 0) ab[m + m - 1] = T(0);
}

constexpr int TC_BM = 64, TC_BN = 64;  // the f32 kernel's tile GEMMs
using TcTile = tc32::Tile<TC_BM, TC_BN>;
// ring depth of the f32 kernel's tile streams

// Sum over the block; every thread gets the result.  Fixed order.
template <typename T>
__device__ T block_sum_t(T v, T* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = heff::warp_sum(v);
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    T s = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
    s = heff::warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// The coupling fold in place: for each (c, b) of the instance, the M*nt
// values P[(w,c)][(t,b)] become Q[(v,c)][(s,b)] = sum_{w,t}
// cs[(w*nt+t)*M*nt + v*nt+s] P[(w,c)][(t,b)] at the same positions.
template <int MC, int NTC>
__device__ void fold_in_place(const float* cs, float* P, int chi, int nt_,
                              int M_) {
  const int M = MC ? MC : M_, nt = NTC ? NTC : nt_;
  const int mn = M * nt;
  const size_t ldp = (size_t)nt * chi, wstep = (size_t)chi * ldp;
  for (int e = threadIdx.x; e < chi * chi; e += blockDim.x) {
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
      for (int i = 0; i < MN; ++i) p[(i / NTC) * wstep + (i % NTC) * chi] = q[i];
    } else {
      float q[tc32::MAX_MN];
#pragma unroll
      for (int i = 0; i < tc32::MAX_MN; ++i) q[i] = 0.f;
      for (int j = 0; j < mn; ++j) {
        const float pv = p[(j / nt) * wstep + (j % nt) * chi];
        const float* cw = cs + j * mn;
#pragma unroll
        for (int i = 0; i < tc32::MAX_MN; ++i)
          if (i < mn) q[i] += cw[i] * pv;
      }
#pragma unroll
      for (int i = 0; i < tc32::MAX_MN; ++i)
        if (i < mn) p[(i / nt) * wstep + (i % nt) * chi] = q[i];
    }
  }
}

// f32: the matvec on the 3xTF32 tensor-core tile GEMM.  MC, NTC: M and nt
// at compile time (the path shapes M=3, nt=2 or 4), or 0: at run time.
template <int MC, int NTC>
__global__ void __launch_bounds__(tc32::THREADS, 2)
    fused_lanczos_tc_kernel(const float* __restrict__ W, long long w_stride,
                            const float* __restrict__ Lt,
                            const float* __restrict__ Rt,
                            const float* __restrict__ x0, float* V,
                            float* __restrict__ ab, float* Pbuf, float* wbuf,
                            int chi, int nt, int M, int m, float delta) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ float cs[heff::MAX_COUPLINGS];  // cs[(w*nt+t)*M*nt + v*nt+s]
  __shared__ double red[33];
  const float LARGE = 1e10f;
  const size_t plane = (size_t)chi * chi;
  const size_t n = nt * plane;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int mn = M * nt;

  Lt += b * M * plane;
  Rt += b * M * plane;
  x0 += b * n;
  V += b * (size_t)m * n;
  ab += b * 2 * m;
  float* P = Pbuf + b * mn * plane;
  float* w = wbuf + b * n;
  for (int e = tid; e < mn * mn; e += blockDim.x) {
    const int t = e % nt, s = (e / nt) % nt, v = (e / (nt * nt)) % M,
              wi = e / (nt * nt * M);
    cs[(wi * nt + t) * mn + v * nt + s] = W[b * w_stride + e];
  }
  // 16-byte cp.async where every row start is 16-byte aligned, and 16-byte
  // vector passes where every vector is
  const bool vec =
      chi % 4 == 0 &&
      (((uintptr_t)Lt | (uintptr_t)Rt | (uintptr_t)V | (uintptr_t)P) & 15) == 0;
  const bool v4 = n % 4 == 0 && (((uintptr_t)V | (uintptr_t)w) & 15) == 0;

  // <x0, x0>, <v, w> and |w|^2: exact f32 products summed in f64, in a
  // fixed order, rounded once
  double part = 0.0;
  for (size_t e = tid; e < n; e += blockDim.x)
    part += (double)x0[e] * (double)x0[e];
  const float nrm = (float)sqrt(block_sum_t(part, red));
  bool alive = nrm > delta;
  float inv = alive ? 1.f / nrm : 0.f;
  for (size_t e = tid; e < n; e += blockDim.x) V[e] = x0[e] * inv;
  float beta_prev = 0.f;

  constexpr int BK = tc32::BK;
  const int ct = (chi + TC_BN - 1) / TC_BN;        // column tiles of a plane
  const int rt1 = (M * chi + TC_BM - 1) / TC_BM;   // stage-1 row tiles
  const int nkv = (chi + BK - 1) / BK;             // ring stages of depth chi
  const size_t ldp = (size_t)nt * chi;
  for (int j = 0; j < m; ++j) {
    __syncthreads();  // V[j] is complete
    const float* v = V + j * n;
    const float* vp = j > 0 ? V + (j - 1) * n : v;  // read only when j > 0

    // stage 1: P = [Lt_0; ...; Lt_M-1] @ [v_0 ... v_nt-1], job (row tile,
    // t, column tile), nkv stages each
    float acc1[TcTile::MT][TcTile::NT][4] = {};
    tc32::gemm_stream<TC_BM, TC_BN, true>(
        rt1 * nt * ct, nkv,
        [&](int job, int q, float* As, float* Bs) {
          const int r0 = (job / (nt * ct)) * TC_BM, t = (job / ct) % nt;
          const int c0 = (job % ct) * TC_BN;
          tc32::load_stage<TC_BM, TC_BN>(
              As, Bs, Lt + (size_t)r0 * chi + q * BK, chi,
              v + t * plane + (size_t)q * BK * chi + c0, chi, M * chi - r0,
              chi - c0, chi - q * BK, vec);
        },
        [&](int job, const float(&acc)[TcTile::MT][TcTile::NT][4]) {
          const int r0 = (job / (nt * ct)) * TC_BM, t = (job / ct) % nt;
          const int c0 = (job % ct) * TC_BN;
          const int rows = M * chi - r0, cols = chi - c0;
          float* out = P + (size_t)r0 * ldp + (size_t)t * chi + c0;
          tc32::for_each_acc<TC_BM, TC_BN>(acc, [&](int r, int c, float x) {
            if (r < rows && c < cols) out[(size_t)r * ldp + c] = x;
          });
        },
        acc1, ring);
    __syncthreads();  // every P value is complete
    fold_in_place<MC, NTC>(cs, P, chi, nt, M);
    __syncthreads();  // every Q value is complete

    // stage 2: w_s = sum_v Q_vs @ Rt_v, job (s, output tile), M nkv stages
    // each (v major), and this thread's share of <v, w>
    part = 0.0;
    float acc2[TcTile::MT][TcTile::NT][4] = {};
    tc32::gemm_stream<TC_BM, TC_BN, true>(
        nt * ct * ct, M * nkv,
        [&](int job, int q, float* As, float* Bs) {
          const int vv = q / nkv, kt = q - vv * nkv;
          const int s = job / (ct * ct), tile = job % (ct * ct);
          const int r0 = (tile / ct) * TC_BM, c0 = (tile % ct) * TC_BN;
          tc32::load_stage<TC_BM, TC_BN>(
              As, Bs, P + ((size_t)vv * chi + r0) * ldp + (size_t)s * chi + kt * BK,
              (int)ldp, Rt + vv * plane + (size_t)kt * BK * chi + c0, chi,
              chi - r0, chi - c0, chi - kt * BK, vec);
        },
        [&](int job, const float(&acc)[TcTile::MT][TcTile::NT][4]) {
          const int s = job / (ct * ct), tile = job % (ct * ct);
          const int r0 = (tile / ct) * TC_BM, c0 = (tile % ct) * TC_BN;
          const int rows = chi - r0, cols = chi - c0;
          const size_t off = s * plane + (size_t)r0 * chi + c0;
          tc32::for_each_acc<TC_BM, TC_BN>(acc, [&](int r, int c, float x) {
            if (r < rows && c < cols) {
              w[off + (size_t)r * chi + c] = x;
              part += (double)v[off + (size_t)r * chi + c] * (double)x;
            }
          });
        },
        acc2, ring);
    const float alpha = (float)block_sum_t(part, red);  // publishes w
    if (tid == 0) ab[j] = alive ? alpha : LARGE;

    // each thread updates, and later rescales, only its own elements: 16
    // bytes at a time where every vector is 16-byte aligned, so that a
    // thread's loads are in flight together
    part = 0.0;
    auto update = [&](float we, float ve, float pe) {
      we -= alpha * ve;
      if (j > 0) we -= beta_prev * pe;
      part += (double)we * (double)we;
      return we;
    };
    if (v4) {
      float4* w4 = reinterpret_cast<float4*>(w);
      const float4* v_4 = reinterpret_cast<const float4*>(v);
      const float4* p_4 = reinterpret_cast<const float4*>(vp);
#pragma unroll 4
      for (size_t q = tid; q < n / 4; q += blockDim.x) {
        float4 a = w4[q];
        const float4 c = v_4[q], e = p_4[q];
        a.x = update(a.x, c.x, e.x);
        a.y = update(a.y, c.y, e.y);
        a.z = update(a.z, c.z, e.z);
        a.w = update(a.w, c.w, e.w);
        w4[q] = a;
      }
    } else {
      for (size_t e = tid; e < n; e += blockDim.x)
        w[e] = update(w[e], v[e], vp[e]);
    }
    const float beta = (float)sqrt(block_sum_t(part, red));
    const bool alive_next = alive && beta > delta;
    if (j < m - 1) {
      if (tid == 0) ab[m + j] = alive_next ? beta : 0.f;
      inv = beta > delta ? 1.f / beta : 0.f;
      const float keep = alive_next ? 1.f : 0.f;
      float* vn = V + (j + 1) * n;
      if (v4) {
        const float4* w4 = reinterpret_cast<const float4*>(w);
        float4* vn4 = reinterpret_cast<float4*>(vn);
#pragma unroll 4
        for (size_t q = tid; q < n / 4; q += blockDim.x) {
          const float4 a = w4[q];
          vn4[q] = make_float4(a.x * inv * keep, a.y * inv * keep,
                               a.z * inv * keep, a.w * inv * keep);
        }
      } else {
        for (size_t e = tid; e < n; e += blockDim.x) vn[e] = w[e] * inv * keep;
      }
    }
    beta_prev = alive_next ? beta : 0.f;
    alive = alive_next;
  }
  if (tid == 0) ab[m + m - 1] = 0.f;
}

template <int MC, int NTC>
cudaError_t launch_tc(const float* W, long long w_stride, const float* Lt,
                      const float* Rt, const float* x0, float* V, float* ab,
                      float* P, float* w, int B, int chi, int nt, int M,
                      int m, float delta, cudaStream_t stream) {
  auto kern = fused_lanczos_tc_kernel<MC, NTC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TcTile::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<B, tc32::THREADS, TcTile::SMEM, stream>>>(
      W, w_stride, Lt, Rt, x0, V, ab, P, w, chi, nt, M, m, delta);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* W, long long w_stride, const T* Lt, const T* Rt,
           const T* x0, T* V, T* ab, T* P, T* w, int B, int chi, int d,
           int M, int m, double delta, cudaStream_t stream) {
  fused_lanczos_kernel<T><<<B, heff::THREADS, 0, stream>>>(
      W, w_stride, Lt, Rt, x0, V, ab, P, w, chi, d, M, m, (T)delta);
  return (int)cudaGetLastError();
}

}  // namespace

// W: (M,M,d,d) shared (w_stride 0) or one per instance (w_stride M*M*d*d);
// d is the number of physical tiles nt (d, or d*d two-site).
// Lt, Rt: (B,M,chi,chi); x0: (B,d,chi,chi); V: (B,m,d,chi,chi);
// ab: (B,2,m); scratch P: (B,M*d,chi,chi), w: (B,d,chi,chi).  f32 runs
// the 3xTF32 tensor-core kernel, f64 the SIMT one.
// Returns cudaGetLastError() after the launch.
extern "C" int tn_fused_lanczos_f32(const float* W, long long w_stride,
                                    const float* Lt, const float* Rt,
                                    const float* x0, float* V, float* ab,
                                    float* P, float* w, int B, int chi,
                                    int d, int M, int m, double delta,
                                    void* stream) {
  if (M * d > tc32::MAX_MN) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float dl = (float)delta;
  if (M == 3 && d == 2)
    return (int)launch_tc<3, 2>(W, w_stride, Lt, Rt, x0, V, ab, P, w, B, chi,
                                d, M, m, dl, st);
  if (M == 3 && d == 4)
    return (int)launch_tc<3, 4>(W, w_stride, Lt, Rt, x0, V, ab, P, w, B, chi,
                                d, M, m, dl, st);
  return (int)launch_tc<0, 0>(W, w_stride, Lt, Rt, x0, V, ab, P, w, B, chi, d,
                              M, m, dl, st);
}

extern "C" int tn_fused_lanczos_f64(const double* W, long long w_stride,
                                    const double* Lt, const double* Rt,
                                    const double* x0, double* V, double* ab,
                                    double* P, double* w, int B, int chi,
                                    int d, int M, int m, double delta,
                                    void* stream) {
  return launch<double>(W, w_stride, Lt, Rt, x0, V, ab, P, w, B, chi, d, M,
                        m, delta, (cudaStream_t)stream);
}
