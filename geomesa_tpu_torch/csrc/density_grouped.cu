// Masked, optionally weighted 2-D density histogram over the compacted
// [C, B] scan layout, driven by a per-tile schedule of chunk ids.
//
// Replaces geomesa_tpu/kernels/density_pallas.py::density_grid_grouped (its
// inner `kernel`: one grid step per (chunk, 128x128 tile) pair, sorted by
// tile, accumulating one-hot products into the tile).
//
// Bound: memory. Each scheduled row's weight (4 bytes) is read once, its x
// and y (8 bytes) only where the weight is non-zero, and the H x W f32 grid
// is written once; the arithmetic per row is a few f32 operations.
//
// Design: the TPU kernel carries a tile's sum across sequential grid steps
// in VMEM; here blocks run in parallel, so each block owns one SEGMENT of
// one tile's chunk run. It zeroes a 128x128 f32 tile in dynamic shared
// memory (64 KB), walks its chunks, computes every row's cell exactly as
// the reference does (f32, op by op: clip(int((x - x0) / dx * width)),
// IEEE division, no contraction) and adds rows that land in its tile with
// shared-memory atomics. It then adds its non-zero cells into a pre-zeroed
// [H, W] grid, cropped to the grid, with global atomics (several segments
// may share a tile). Segments are sized on the host to occupy every SM;
// every cell goes through the zeroed grid, so nothing plays the role of the
// reference's `seen` mask. Unweighted counts stay exact (integer-valued f32
// below 2^24 per cell in any order); weighted sums depend on atomic order.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 512;

__device__ __forceinline__ int cell_of(float v, float lo, float span, int n) {
  const float q = __fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), (float)n);
  const int c = (int)q;  // truncation toward zero, as astype(int32)
  return min(max(c, 0), n - 1);
}

__global__ void density_grouped_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, int B, const int* __restrict__ seg_tile,
    const int* __restrict__ seg_begin, const int* __restrict__ seg_end,
    const int* __restrict__ chunks, int ntx, float x0, float y0, float dx,
    float dy, int width, int height, float* __restrict__ grid) {
  extern __shared__ float acc[];  // kTile * kTile
  const int s = blockIdx.x;
  const int t = seg_tile[s];
  const int ox = (t % ntx) * kTile;
  const int oy = (t / ntx) * kTile;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const int k1 = seg_end[s];
  for (int k = seg_begin[s]; k < k1; ++k) {
    const long long base = (long long)chunks[k] * B;
    for (int r = threadIdx.x; r < B; r += blockDim.x) {
      const float wr = w[base + r];
      if (wr == 0.0f) continue;  // masked-out row: adds nothing
      const int cx = cell_of(x[base + r], x0, dx, width) - ox;
      const int cy = cell_of(y[base + r], y0, dy, height) - oy;
      if ((unsigned)cx < (unsigned)kTile && (unsigned)cy < (unsigned)kTile)
        atomicAdd(&acc[cy * kTile + cx], wr);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const float v = acc[i];
    if (v == 0.0f) continue;
    const int gx = ox + i % kTile;
    const int gy = oy + i / kTile;
    if (gx < width && gy < height)
      atomicAdd(&grid[(long long)gy * width + gx], v);
  }
}

}  // namespace

// x, y, w: [C, B] f32 (w = the mask as 0/1, or the masked weight);
// segments s in [0, nseg): tile seg_tile[s] over chunks[seg_begin[s] ..
// seg_end[s]); grid: pre-zeroed [height, width] f32. Returns
// cudaGetLastError() (or the attribute call's error).
extern "C" int gm_density_grouped_launch(
    const float* x, const float* y, const float* w, int B,
    const int* seg_tile, const int* seg_begin, const int* seg_end,
    const int* chunks, int nseg, int ntx, float x0, float y0, float dx,
    float dy, int width, int height, float* grid, cudaStream_t stream) {
  if (nseg <= 0) return 0;
  const int smem = kTile * kTile * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      density_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  density_grouped_kernel<<<nseg, kThreads, smem, stream>>>(
      x, y, w, B, seg_tile, seg_begin, seg_end, chunks, ntx, x0, y0, dx, dy,
      width, height, grid);
  return (int)cudaGetLastError();
}
