// Chained-GEMM probe: P independent chains of
//   y = bf16(x @ b);  x = bf16(y @ c)      (f32 accumulation)
// repeated `reps` times on x (M,K), b (K,N), c (N,K), all bf16.
//
// Replaces: benchmarks/mxu_micro.py make_chain_kernel (the function that
// reaches its pallas_call), the TPU's matrix-unit issue-rate probe.  The
// H100 has no MXU: here it probes the issue rate and latency of dependent
// bf16 tensor-core GEMMs.
//
// What bounds it on the H100: operations, 4*M*K*N flops per chain and rep
// at the bf16 tensor-core peak (989 TFLOP/s); its operands are a few MB
// at most.  In practice the dependence between steps bounds it: a step
// starts when the previous one is complete, as on the TPU (P=1 measures
// the latency of one dependent GEMM), and P*ceil(M/64) blocks leave most
// of the 132 SMs idle at every ladder shape.
//
// Row i of x @ b @ c depends on row i of x only, so a block owns a panel
// of rows of one chain across all reps and needs no grid-wide
// synchronisation.  Two routes (ops/kernels.py gemm_chain_route):
//
// "wgmma" (K, N multiples of 64, where gemm_chain_plan fits): one block
// per 64-row panel (wgmma's M) of one chain.  The panels x (64 x K) and y
// (64 x N) live in shared memory in the 128-byte-swizzled K-major layout
// that wgmma reads its A operand from: 64-column blocks of 64 rows x 128
// bytes, the 16-byte chunk j of row r at chunk j ^ (r % 8).  The first x
// comes in by TMA (a 3-D map over (P, M, K), so the rows of a panel past
// M, when M % 64 == 32, are zero-filled and never stored).  b and c are
// wgmma's B operand, N-major as they lie in memory (imm-trans-b), in
// slabs of kd rows x NC columns, each the NC/64 TMA boxes of kd x 64 in
// the same swizzle: either resident, loaded once with x where all of b
// and c fit beside the panels, or streamed through a ring of 2-4 stages
// by one producer warp (TMA + full/empty mbarriers) in the order the
// consumer warpgroup takes them, rep after rep.  Each product runs in
// output chunks of NC = 256, 128 or 64 columns (one wgmma.mma_async
// m64nNCk16 per 16-deep step, NC/2 f32 accumulators a thread), committed
// per slab; the epilogue rounds by __float2bfloat16_rn and writes the
// chunk straight into the next product's A panel, in the swizzled
// layout, then fence.proxy.async and a warpgroup barrier before the next
// wgmma reads it.  The last x leaves by TMA store.  The slab depth kd
// and the ring's stages are chosen by ops/kernels.py gemm_chain_plan
// alone and passed in; this file lays them out (smem_bytes) and refuses
// only what its templates, its barriers or the block's shared memory
// cannot take.  The plan's footprints at the ladder shapes (bytes of
// dynamic shared memory; the limit is 232,448):
//   (128,128,128)  resident          99,400
//   (128,128,256)  resident         181,320
//   (128,128,512)  ring 4 x 64x256  214,088
//   (128,256,256)  ring 4 x 64x256  197,704
//   (256,256,256)  ring 4 x 64x256  197,704
//   (256,256,512)  ring 4 x 64x256  230,472
//   (512,512,512)  ring 3 x 64x256  230,472
//   (512,512,1024) ring 2 x 32x256  230,472
//
// "wmma" (every other admitted shape: M % 32 == 0, K, N % 16 == 0): the
// first port, kept for those shapes and to be timed beside the wgmma
// route.  A block owns 32 rows; x (32 x K) and y (32 x N) stay in shared
// memory, b and c are read as WMMA fragments straight from device memory
// (L2) at every rep; eight warps split the 16x16 output fragments, each
// rounding its accumulator to bf16 through a 1 KB staging tile.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// route "wmma"
// ---------------------------------------------------------------------------

namespace wm {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 32;  // rows of one chain per block
constexpr int F = 16;   // fragment edge

inline size_t smem_bytes(int K, int N) {
  return (size_t)RB * (K + N) * sizeof(bf16) + (size_t)WARPS * F * F * 4;
}

// dst (RB x n, leading dimension n) = bf16(src (RB x k, shared) @ Bg (k x n,
// device memory)).  stage: this warp's 16x16 f32 tile.
__device__ void panel_product(const bf16* src, int k, const bf16* Bg, int n,
                              bf16* dst, float* stage) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int fcols = n / F, frags = (RB / F) * fcols;
  for (int f = warp; f < frags; f += WARPS) {
    const int fr = f / fcols, fc = f % fcols;
    wmma::fragment<wmma::accumulator, F, F, F, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < k; kk += F) {
      wmma::fragment<wmma::matrix_a, F, F, F, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, F, F, F, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(af, src + fr * F * k + kk, k);
      wmma::load_matrix_sync(bfr, Bg + (size_t)kk * n + fc * F, n);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(stage, acc, F, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < F * F; e += 32)
      dst[(fr * F + e / F) * n + fc * F + e % F] = __float2bfloat16_rn(stage[e]);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS)
    chain_kernel(const bf16* __restrict__ x, const bf16* __restrict__ b,
                 const bf16* __restrict__ c, bf16* __restrict__ out, int M,
                 int K, int N, int reps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // RB x K
  bf16* ys = xs + RB * K;                        // RB x N
  float* stage = reinterpret_cast<float*>(ys + RB * N) + (threadIdx.x / 32) * F * F;
  const int panels = M / RB;
  const size_t row0 = (size_t)(blockIdx.x / panels) * M + (blockIdx.x % panels) * RB;
  // RB*K bf16 = 4*K uint4 (K % 16 == 0); the panel is contiguous
  const int n16 = RB * K * (int)sizeof(bf16) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(x + row0 * K);
  for (int e = threadIdx.x; e < n16; e += THREADS)
    reinterpret_cast<uint4*>(xs)[e] = src[e];
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
    panel_product(xs, K, b, N, ys, stage);
    __syncthreads();
    panel_product(ys, N, c, K, xs, stage);
    __syncthreads();
  }
  uint4* dst = reinterpret_cast<uint4*>(out + row0 * K);
  for (int e = threadIdx.x; e < n16; e += THREADS)
    dst[e] = reinterpret_cast<const uint4*>(xs)[e];
}

int launch(const bf16* x, const bf16* b, const bf16* c, bf16* out, int P,
           int M, int K, int N, int reps, cudaStream_t stream) {
  if (M % RB || K % F || N % F) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(K, N);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  chain_kernel<<<P * (M / RB), THREADS, bytes, stream>>>(x, b, c, out, M, K,
                                                         N, reps);
  return (int)cudaGetLastError();
}

}  // namespace wm

// ---------------------------------------------------------------------------
// route "wgmma"
// ---------------------------------------------------------------------------

namespace wg {

constexpr int ROWS = 64;                // rows of a panel: wgmma's M
constexpr int CONSUMER = 128;           // the warpgroup that issues wgmma
constexpr int THREADS = CONSUMER + 32;  // and one producer warp
constexpr int SPAN = 64;                // bf16 columns of a 128-byte row
constexpr int BLOCK = ROWS * 128;       // bytes of a 64 x 64 panel block
constexpr int MAX_STAGES = 4;
constexpr int BARRIERS = 1 + 2 * MAX_STAGES;  // x, full[], empty[]
constexpr int ALIGN = 1024;  // a 128B-swizzle atom: 8 rows x 128 bytes
constexpr size_t SMEM_LIMIT = 232448;

// the output chunk of a product `w` columns wide: one wgmma's N
constexpr int chunk(int w) { return w % 256 == 0 ? 256 : w % 128 == 0 ? 128 : 64; }

// dynamic shared memory: alignment slack, the panels x and y, b and c
// resident (stages == 0) or the ring, the barriers
inline size_t smem_bytes(int K, int N, int kd, int stages) {
  const int nc = chunk(N) > chunk(K) ? chunk(N) : chunk(K);
  const size_t breg = stages == 0 ? (size_t)4 * K * N
                                  : (size_t)stages * kd * nc * 2;
  return ALIGN + (size_t)128 * (K + N) + breg + 8 * BARRIERS;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"((uint64_t)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// this thread's generic-proxy writes to shared memory, made visible to
// the async proxy (wgmma operand reads, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of the consumer warpgroup alone (the producer warp may have
// left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all >> 4), layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// A (a panel), K-major: rows 128 bytes apart, 8-row atoms 1024 bytes
// apart (the leading offset is unused with a swizzle); a 16-deep step
// within a 64-column block starts 32 bytes further
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return desc(addr, 16, 1024);
}

// B (a slab of kd rows x NC columns), N-major: its 64-column blocks lbo =
// kd*128 bytes apart, its 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_b(uint32_t addr, uint32_t lbo) {
  return desc(addr, lbo, 1024);
}

// d (64 x N, f32, the accumulator fragment) = A (64 x 16) @ B (16 x N)
// + (scale_d ? d : 0); A K-major, B N-major (imm-trans-b = 1)
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db,
                                      int scale_d);

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<256>(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115,"
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126,"
      "%127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// dst[:, n0 : n0+NC] for each output chunk = bf16(a (64 x depth) @ B),
// B the product's slabs in the order the producer issues them: resident
// at `res` (chunk-major, kd-deep, kd*NC*2 bytes each), or from the ring
// (q counts the slabs taken).  Ends with dst visible to the next
// product's wgmma.
template <int NC, int KD>
__device__ __forceinline__ void product(const unsigned char* a, int depth,
                                        unsigned char* dst, int width,
                                        const unsigned char* res,
                                        const unsigned char* ring, int slot,
                                        uint64_t* full, uint64_t* empty,
                                        int stages, int& q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t a0 = smem_u32(a), lbo = KD * 128;
  for (int n0 = 0; n0 < width; n0 += NC) {
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    int held = -1;  // the ring stage of the previous slab, not yet released
    for (int k0 = 0; k0 < depth; k0 += KD) {
      uint32_t slab;
      int s = -1;
      if (res) {
        slab = smem_u32(res) + ((n0 / NC) * (depth / KD) + k0 / KD) * KD * NC * 2;
      } else {
        s = q % stages;
        mbar_wait(full + s, (q / stages) & 1);
        slab = smem_u32(ring) + s * slot;
        ++q;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; kk += 16) {
        const int k = k0 + kk;
        wgmma<NC>(acc, desc_a(a0 + (k / SPAN) * BLOCK + (k % SPAN) * 2),
                  desc_b(slab + kk * 128, lbo), k > 0);
      }
      wgmma_commit();
      if (s >= 0) {  // the previous slab's products are done: release it
        wgmma_wait<1>();
        if (held >= 0 && lane == 0) mbar_arrive(empty + held);
        held = s;
      }
    }
    wgmma_wait<0>();
    if (held >= 0 && lane == 0) mbar_arrive(empty + held);
    // the fragment: rows 16*warp + lane/4 (+8), columns 8j + 2*(lane%4)
    // (+1); written as bf16 pairs into dst's swizzled blocks
    const int r = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      unsigned char* blk = dst + (col / SPAN) * BLOCK;
      const int cb = (col % SPAN) * 2;
      *reinterpret_cast<__nv_bfloat162*>(blk + r * 128 + (cb ^ ((r & 7) << 4))) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(blk + (r + 8) * 128 +
                                         (cb ^ ((r & 7) << 4))) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  fence_proxy_async();
  consumer_sync();
}

// One block per 64-row panel of one chain (blockIdx.x = chain * panels +
// panel).  Threads 0-127 (one warpgroup) run the products; thread 128
// issues every TMA load.  Slabs KD rows deep (a compile-time depth, so
// that a slab's wgmmas issue back to back); stages == 0: b and c
// resident.
template <int NC1, int NC2, int KD>
__global__ void __launch_bounds__(THREADS, 1)
    chain_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap,
                 const __grid_constant__ CUtensorMap omap, int K, int N,
                 int panels, int reps, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* xs = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) &
                                  (ALIGN - 1));
  unsigned char* ys = xs + 128 * K;
  unsigned char* bs = ys + 128 * N;
  const bool resident = stages == 0;
  constexpr int NCM = NC1 > NC2 ? NC1 : NC2;
  const int slot = KD * NCM * 2;
  uint64_t* xbar = reinterpret_cast<uint64_t*>(
      bs + (resident ? (size_t)4 * K * N : (size_t)stages * slot));
  uint64_t* full = xbar + 1;
  uint64_t* empty = full + MAX_STAGES;
  const int chain = blockIdx.x / panels, row0 = (blockIdx.x % panels) * ROWS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(xbar, 1);
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMER) {  // the producer warp: one thread issues the loads
    if (tid != CONSUMER) return;
    const uint32_t xbytes = 128 * K;
    mbar_expect_tx(xbar, xbytes + (resident ? 4u * K * N : 0u));
    for (int k = 0; k < K; k += SPAN)
      tma_load_3d(xs + (k / SPAN) * BLOCK, &xmap, xbar, k, row0, chain);
    // the slabs of product 1 (b: K deep, N wide), then product 2 (c: N
    // deep, K wide), chunk-major, kd rows at a time
    auto slabs = [&](auto&& take) {
      for (int prod = 0; prod < 2; ++prod) {
        const int nc = prod ? NC2 : NC1, width = prod ? K : N;
        const int depth = prod ? N : K;
        const CUtensorMap* map = prod ? &cmap : &bmap;
        for (int n0 = 0; n0 < width; n0 += nc)
          for (int k0 = 0; k0 < depth; k0 += KD) take(map, nc, n0, k0);
      }
    };
    if (resident) {
      unsigned char* dst = bs;
      slabs([&](const CUtensorMap* map, int nc, int n0, int k0) {
        for (int j = 0; j < nc / SPAN; ++j)
          tma_load_2d(dst + j * KD * 128, map, xbar, n0 + j * SPAN, k0);
        dst += KD * nc * 2;
      });
      return;
    }
    int q = 0;
    for (int r = 0; r < reps; ++r)
      slabs([&](const CUtensorMap* map, int nc, int n0, int k0) {
        const int s = q % stages;
        mbar_wait(empty + s, ((q / stages) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(full + s, KD * nc * 2);
        for (int j = 0; j < nc / SPAN; ++j)
          tma_load_2d(bs + s * slot + j * KD * 128, map, full + s,
                      n0 + j * SPAN, k0);
        ++q;
      });
    return;
  }

  mbar_wait(xbar, 0);  // x (and resident b, c) landed
  const unsigned char* res_b = resident ? bs : nullptr;
  const unsigned char* res_c = resident ? bs + (size_t)2 * K * N : nullptr;
  int q = 0;
  for (int r = 0; r < reps; ++r) {
    product<NC1, KD>(xs, K, ys, N, res_b, bs, slot, full, empty, stages, q);
    product<NC2, KD>(ys, N, xs, K, res_c, bs, slot, full, empty, stages, q);
  }
  if (tid == 0) {  // x's last value out; rows past M are clipped
    for (int k = 0; k < K; k += SPAN)
      tma_store_3d(&omap, xs + (k / SPAN) * BLOCK, k, row0, chain);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 map over `rank` dims (innermost first) of a contiguous tensor,
// boxes of box[] elements, 128-byte swizzle, zero fill out of bounds
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint32_t* box) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t strides[2];
  cuuint64_t s = dims[0] * sizeof(bf16);
  for (int i = 0; i + 1 < rank; ++i) {
    strides[i] = s;
    s *= dims[i + 1];
  }
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC1, int NC2, int KD>
int launch_nc(const CUtensorMap (&maps)[4], int P, int M, int K, int N,
              int reps, int stages, cudaStream_t stream) {
  auto kern = chain_kernel<NC1, NC2, KD>;
  const size_t bytes = smem_bytes(K, N, KD, stages);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int panels = (M + ROWS - 1) / ROWS;
  kern<<<P * panels, THREADS, bytes, stream>>>(maps[0], maps[1], maps[2],
                                               maps[3], K, N, panels, reps,
                                               stages);
  return (int)cudaGetLastError();
}

template <int NC1, int NC2>
int launch_kd(const CUtensorMap (&maps)[4], int P, int M, int K, int N,
              int reps, int kd, int stages, cudaStream_t stream) {
  return kd == 64
             ? launch_nc<NC1, NC2, 64>(maps, P, M, K, N, reps, stages, stream)
             : launch_nc<NC1, NC2, 32>(maps, P, M, K, N, reps, stages, stream);
}

template <int NC1>
int launch_nc1(const CUtensorMap (&maps)[4], int P, int M, int K, int N,
               int reps, int kd, int stages, cudaStream_t stream) {
  switch (chunk(K)) {
    case 256:
      return launch_kd<NC1, 256>(maps, P, M, K, N, reps, kd, stages, stream);
    case 128:
      return launch_kd<NC1, 128>(maps, P, M, K, N, reps, kd, stages, stream);
    default:
      return launch_kd<NC1, 64>(maps, P, M, K, N, reps, kd, stages, stream);
  }
}

int launch(const bf16* x, const bf16* b, const bf16* c, bf16* out, int P,
           int M, int K, int N, int reps, int kd, int stages,
           cudaStream_t stream) {
  if (M % 32 || K % SPAN || N % SPAN || (kd != 32 && kd != 64) ||
      stages < 0 || stages > MAX_STAGES ||
      smem_bytes(K, N, kd, stages) > SMEM_LIMIT ||
      (((uintptr_t)x | (uintptr_t)b | (uintptr_t)c | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const cuuint64_t xdims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)P};
  const cuuint64_t bdims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t cdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint32_t xbox[3] = {SPAN, ROWS, 1};
  const cuuint32_t slab[2] = {SPAN, (cuuint32_t)kd};
  if (!encode(&maps[0], x, 3, xdims, xbox) ||
      !encode(&maps[1], b, 2, bdims, slab) ||
      !encode(&maps[2], c, 2, cdims, slab) ||
      !encode(&maps[3], out, 3, xdims, xbox))
    return (int)cudaErrorInvalidValue;
  switch (chunk(N)) {
    case 256:
      return launch_nc1<256>(maps, P, M, K, N, reps, kd, stages, stream);
    case 128:
      return launch_nc1<128>(maps, P, M, K, N, reps, kd, stages, stream);
    default:
      return launch_nc1<64>(maps, P, M, K, N, reps, kd, stages, stream);
  }
}

}  // namespace wg

}  // namespace

// x: (P,M,K), b: (K,N), c: (N,K), out: (P,M,K), all bf16 and contiguous.
// route 0 ("wgmma"): M % 32 == 0, K, N % 64 == 0, 16-byte aligned, the
// plan of ops/kernels.py gemm_chain_plan: kd-deep slabs (32 or 64),
// `stages` ring stages (at most 4) or 0 (b and c resident).  route 1 ("wmma"): M % 32 ==
// 0, K, N % 16 == 0; kd and stages are not read.  Returns the first
// error: cudaErrorInvalidValue for a shape, plan or map the route does
// not take, else cudaGetLastError() after the launch.
extern "C" int tn_gemm_chain_bf16(const void* x, const void* b, const void* c,
                                  void* out, int P, int M, int K, int N,
                                  int reps, int route, int kd, int stages,
                                  void* stream) {
  if (P < 1 || M < 32 || reps < 0) return (int)cudaErrorInvalidValue;
  const bf16 *xb = static_cast<const bf16*>(x), *bb = static_cast<const bf16*>(b),
             *cb = static_cast<const bf16*>(c);
  bf16* ob = static_cast<bf16*>(out);
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == 0)
    return wg::launch(xb, bb, cb, ob, P, M, K, N, reps, kd, stages, st);
  if (route == 1) return wm::launch(xb, bb, cb, ob, P, M, K, N, reps, st);
  return (int)cudaErrorInvalidValue;
}
