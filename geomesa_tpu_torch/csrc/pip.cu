// Even-odd point-in-polygon mask for one polygon's packed edge table.
//
// Replaces geomesa_tpu/kernels/pallas_kernels.py::_pip_kernel (launched by
// _pip_call / pip_mask): each point's crossing parity against the edge
// table [4, Ep] (rows x1, y1, y2, slope; padded edges have y1 == y2 == 0 and
// never cross). Multipolygon parts are OR'd by the caller.
//
// Bound: memory, once the work the data needs is counted. Per point the
// kernel reads 8 bytes and writes 1; an edge costs about 6 FP32 operations,
// but only for points whose y lies in the edge's y-span.
//
// What held the first version back was shared-memory issue: one point per
// thread and four scalar shared loads per edge for about seven arithmetic
// operations. This design:
//
// * stages the edge table through shared memory in 1024-edge tiles, as
//   interleaved float4 records (x1, y1, y2, slope), so an edge is one
//   broadcast 16-byte shared load; tiling leaves no edge cap;
// * gives each thread kPer = 4 consecutive points (one float4 of x and one
//   of y where aligned, one 4-byte store of verdicts), so each edge record
//   feeds four independent parity chains;
// * culls exactly, twice: an edge whose y1 and y2 both lie above the
//   points' largest y, or both at or below their smallest, has
//   (y1 > y) == (y2 > y) for every one of those points and changes no
//   verdict. Staging keeps only the edges that survive the block's y-range
//   (compacted into shared memory; parity does not depend on edge order),
//   and each warp then skips those outside its own y-range, reduced by
//   shuffles. Compacted scans hold spatially close points, so most edges
//   are skipped.
//
// The crossing abscissa keeps explicitly rounded intrinsics: nvcc would
// otherwise contract x1 + (y - y1) * slope into an FMA and move near-edge
// verdicts away from the reference's separately rounded f32 result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // points per thread
constexpr int kEdgeTile = 1024;

__global__ void __launch_bounds__(kThreads) pip_kernel(
    const float* __restrict__ x, const float* __restrict__ y, long long n,
    const float* __restrict__ edges, int ep, int n_edges, int vec,
    uint8_t* __restrict__ out) {
  __shared__ float4 s_e[kEdgeTile];
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
  __shared__ int s_n;
  const long long p0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kPer;
  const bool whole = p0 + kPer <= n;
  float px[kPer], py[kPer];
  if (whole && vec) {
    const float4 a = *reinterpret_cast<const float4*>(x + p0);
    const float4 b = *reinterpret_cast<const float4*>(y + p0);
    px[0] = a.x; px[1] = a.y; px[2] = a.z; px[3] = a.w;
    py[0] = b.x; py[1] = b.y; py[2] = b.z; py[3] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool live = p0 + k < n;
      px[k] = live ? x[p0 + k] : 0.0f;
      py[k] = live ? y[p0 + k] : __int_as_float(0x7fc00000);  // NaN never crosses
    }
  }
  // the warp's y-range over its live, non-NaN points (fminf/fmaxf skip NaN)
  float ylo = INFINITY, yhi = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    ylo = fminf(ylo, py[k]);
    yhi = fmaxf(yhi, py[k]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, o));
    yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, o));
  }
  if (threadIdx.x % 32 == 0) {
    s_lo[threadIdx.x / 32] = ylo;
    s_hi[threadIdx.x / 32] = yhi;
  }
  __syncthreads();
  float blo = INFINITY, bhi = -INFINITY;  // the block's y-range
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    blo = fminf(blo, s_lo[w]);
    bhi = fmaxf(bhi, s_hi[w]);
  }
  uint32_t parity[kPer] = {0u, 0u, 0u, 0u};
  for (int base = 0; base < n_edges; base += kEdgeTile) {
    const int m = min(kEdgeTile, n_edges - base);
    __syncthreads();  // the previous tile is fully consumed
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < m; e += kThreads) {
      const float4 E = make_float4(edges[base + e], edges[ep + base + e],
                                   edges[2 * ep + base + e], edges[3 * ep + base + e]);
      if (!(fminf(E.y, E.z) > bhi || fmaxf(E.y, E.z) <= blo)) s_e[atomicAdd(&s_n, 1)] = E;
    }
    __syncthreads();
    const int kept = s_n;
    for (int e = 0; e < kept; ++e) {
      const float4 E = s_e[e];  // x1, y1, y2, slope
      // warp-uniform: no point of the warp has y in this edge's span
      if (fminf(E.y, E.z) > yhi || fmaxf(E.y, E.z) <= ylo) continue;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const bool cond = (E.y > py[k]) != (E.z > py[k]);
        const float xint = __fadd_rn(E.x, __fmul_rn(__fsub_rn(py[k], E.y), E.w));
        parity[k] ^= (cond && (px[k] < xint)) ? 1u : 0u;
      }
    }
  }
  if (whole && vec) {
    *reinterpret_cast<uint32_t*>(out + p0) =
        parity[0] | (parity[1] << 8) | (parity[2] << 16) | (parity[3] << 24);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (p0 + k < n) out[p0 + k] = (uint8_t)parity[k];
  }
}

}  // namespace

// x, y: n f32 points; edges: [4, ep] f32, of which the first n_edges
// columns are real; out: n bytes (0/1). Returns cudaGetLastError().
extern "C" int gm_pip_launch(const float* x, const float* y, long long n,
                             const float* edges, int ep, int n_edges,
                             uint8_t* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0) &&
                  ((uintptr_t)out % 4 == 0);
  const long long per_block = (long long)kThreads * kPer;
  const long long blocks = (n + per_block - 1) / per_block;
  pip_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n, edges, ep,
                                                        n_edges, vec, out);
  return (int)cudaGetLastError();
}
