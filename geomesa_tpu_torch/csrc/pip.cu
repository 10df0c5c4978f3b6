// Even-odd point-in-polygon mask for one polygon's packed edge table.
//
// Replaces geomesa_tpu/kernels/pallas_kernels.py::_pip_kernel (launched by
// _pip_call / pip_mask): each point's crossing parity against the edge
// table [4, Ep] (rows x1, y1, y2, slope; padded edges have y1 == y2 == 0 and
// never cross). Multipolygon parts are OR'd by the caller.
//
// Bound: operations. About 6 FP32 operations per (point, edge) against 9
// bytes per point (two f32 coordinates in, one byte out), so at 64 edges
// the FP32 pipe, not memory, sets the floor.
//
// Design: one thread per point keeps its parity in a register; each block
// stages the edge table through shared memory in 1024-edge tiles (16 KB),
// which every thread then reads as a broadcast. Tiling lifts the TPU
// kernel's 1024-edge VMEM cap. The crossing abscissa is computed with
// explicitly rounded intrinsics: nvcc would otherwise contract
// x1 + (y - y1) * slope into an FMA and move near-edge verdicts away from
// the reference's separately rounded f32 result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEdgeTile = 1024;

__global__ void pip_kernel(const float* __restrict__ x,
                           const float* __restrict__ y, long long n,
                           const float* __restrict__ edges, int ep,
                           int n_edges, uint8_t* __restrict__ out) {
  __shared__ float s_x1[kEdgeTile];
  __shared__ float s_y1[kEdgeTile];
  __shared__ float s_y2[kEdgeTile];
  __shared__ float s_slope[kEdgeTile];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float px = live ? x[i] : 0.0f;
  const float py = live ? y[i] : 0.0f;
  int parity = 0;
  for (int base = 0; base < n_edges; base += kEdgeTile) {
    const int m = min(kEdgeTile, n_edges - base);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = threadIdx.x; e < m; e += blockDim.x) {
      s_x1[e] = edges[base + e];
      s_y1[e] = edges[ep + base + e];
      s_y2[e] = edges[2 * ep + base + e];
      s_slope[e] = edges[3 * ep + base + e];
    }
    __syncthreads();
    for (int e = 0; e < m; ++e) {
      const float y1 = s_y1[e];
      const bool cond = (y1 > py) != (s_y2[e] > py);
      const float xint =
          __fadd_rn(s_x1[e], __fmul_rn(__fsub_rn(py, y1), s_slope[e]));
      parity ^= (cond && (px < xint)) ? 1 : 0;
    }
  }
  if (live) out[i] = (uint8_t)parity;
}

}  // namespace

// x, y: n f32 points; edges: [4, ep] f32, of which the first n_edges
// columns are real; out: n bytes (0/1). Returns cudaGetLastError().
extern "C" int gm_pip_launch(const float* x, const float* y, long long n,
                             const float* edges, int ep, int n_edges,
                             uint8_t* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  pip_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n, edges, ep,
                                                        n_edges, out);
  return (int)cudaGetLastError();
}
