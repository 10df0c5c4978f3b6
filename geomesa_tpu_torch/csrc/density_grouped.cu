// Masked, optionally weighted 2-D density histogram over the compacted
// [C, B] scan layout, driven by a per-tile schedule of chunk ids.
//
// Replaces geomesa_tpu/kernels/density_pallas.py::density_grid_grouped (its
// inner `kernel`: one grid step per (chunk, 128x128 tile) pair, sorted by
// tile, accumulating one-hot products into the tile). Like the reference it
// takes the row mask and the optional weight apart: a row adds its weight
// (or 1) only where the mask is true, so a NaN weight under a false mask
// adds nothing.
//
// Bound: memory. Each scheduled row's mask byte is read once, its x and y
// (and weight) only where the mask is true, and the H x W f32 grid is
// written once; the arithmetic per row is a few f32 operations.
//
// What held the first version back was latency, not bytes: one block per
// segment walked its chunks one dependent load pair at a time, with three
// quarters of its threads idle at B = 128, and flushed its tile into a
// pre-zeroed grid with global atomics. This design:
//
// * streams each segment's chunk rows through a ring of shared-memory
//   stages, each the mask row (128 B), the x and y rows (512 B each) and,
//   when weighted, the weight row of 128 rows; chunks longer than 128 rows
//   are split into 128-row stages. Each of kWarps warps takes every kWarps-th
//   stage of the segment and owns kDepth slots of the ring: its lanes issue
//   16-byte asynchronous copies (cp.async) for the stage kDepth - 1 ahead,
//   one commit group per stage, and wait for the oldest group before
//   binning it, so every warp keeps kDepth - 1 stages of loads in flight
//   without any handoff between warps. Chunk ids are read 32 stages at a
//   time by the lanes and passed round by shuffles. Each lane bins four
//   rows (vector shared loads) into a 128x128 tile in shared memory (u32
//   counts, or f32 sums when weighted); the four rows' cells are computed
//   without branches, so their division chains overlap. The cell arithmetic
//   (two IEEE divisions a row) is a dependent chain, so the block runs as
//   many warps as it can (24); how deep each warp's ring is matters little
//   once its next stage is in flight;
//   Two earlier versions of this kernel fed one ring from a producer warp and
//   handed stages over on mbarriers, first with 1-D bulk copies (the TMA's
//   linear mode), then with the producer's lanes copying: at 128- to
//   512-byte rows the per-request and per-handoff costs, not bytes, set the
//   time, and more consumer warps made it worse.
// * launches the kCluster segments of one tile as one thread-block cluster.
//   After the walk the blocks sum their tiles through distributed shared
//   memory: block r reduces cells [r, r + 1) * 16384 / kCluster of all
//   peers, in peer order, and writes them to the grid with plain stores.
//   Every tile of the grid has a cluster, so the kernel writes the whole
//   grid and nothing zeroes it first; a tile without pairs writes zeros.
//
// Pixel cells are the reference's: f32 op by op, clip(int((v - lo) / span *
// n)), IEEE division, no contraction. Unweighted counts are exact (integer
// sums); weighted sums depend on the order of the shared-memory atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;
constexpr int kCells = kTile * kTile;
constexpr int kCluster = 8;
constexpr int kRows = 128;  // rows per ring stage
constexpr int kWarps = 24;
constexpr int kDepth = 3;  // ring slots per warp: kDepth - 1 stages in flight
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = kWarps * kDepth;

// dynamic shared memory layout (every offset a multiple of 16 bytes)
constexpr int kAccBytes = kCells * 4;
constexpr int kXOff = kAccBytes;
constexpr int kYOff = kXOff + kSlots * kRows * 4;
constexpr int kWOff = kYOff + kSlots * kRows * 4;
constexpr int kMOff = kWOff + kSlots * kRows * 4;
constexpr int kSmemBytes = kMOff + kSlots * kRows;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most kDepth - 2 of this thread's commit groups are pending
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kDepth - 2) : "memory");
}

__device__ __forceinline__ int cell_of(float v, float lo, float span, int n) {
  const float q = __fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), (float)n);
  const int c = (int)q;  // truncation toward zero, as astype(int32)
  return min(max(c, 0), n - 1);
}

struct Grid {
  float x0, y0, dx, dy;
  int width, height, ox, oy;
};

// one lane's four rows: every cell first, without branches, so the eight
// independent divisions overlap; then the in-tile, masked-in rows' adds
template <bool kWeighted>
__device__ __forceinline__ void bin4(uchar4 m, float4 xv, float4 yv, float4 wv,
                                     const Grid& g, void* acc) {
  const unsigned char ms[4] = {m.x, m.y, m.z, m.w};
  const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
  const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
  int cell[4];
  bool add[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cx = cell_of(xs[i], g.x0, g.dx, g.width) - g.ox;
    const int cy = cell_of(ys[i], g.y0, g.dy, g.height) - g.oy;
    add[i] = ms[i] && (unsigned)cx < (unsigned)kTile && (unsigned)cy < (unsigned)kTile;
    cell[i] = cy * kTile + cx;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!add[i]) continue;
    if (kWeighted)
      atomicAdd(static_cast<float*>(acc) + cell[i], ws[i]);
    else
      atomicAdd(static_cast<unsigned*>(acc) + cell[i], 1u);
  }
}

template <bool kWeighted>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    density_grouped_kernel(const float* __restrict__ x,
                           const float* __restrict__ y,
                           const unsigned char* __restrict__ mask,
                           const float* __restrict__ weight, int B,
                           const int* __restrict__ seg_tile,
                           const int* __restrict__ seg_begin,
                           const int* __restrict__ seg_end,
                           const int* __restrict__ chunks, int ntx, float x0,
                           float y0, float dx, float dy, int width, int height,
                           float* __restrict__ grid) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int s = blockIdx.x;
  const int rank = (int)cluster.block_rank();
  const int t = seg_tile[s];
  Grid g{x0, y0, dx, dy, width, height, (t % ntx) * kTile, (t / ntx) * kTile};
  const int share = kCells / kCluster;
  const int cell0 = rank * share;

  // a tile without pairs: every block of its cluster writes zeros
  const int first = s - rank;
  if (seg_begin[first] == seg_end[first + kCluster - 1]) {
    for (int i = threadIdx.x; i < share; i += blockDim.x) {
      const int gx = g.ox + (cell0 + i) % kTile;
      const int gy = g.oy + (cell0 + i) / kTile;
      if (gx < width && gy < height) grid[(long long)gy * width + gx] = 0.0f;
    }
    return;
  }

  float4* acc4 = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < kCells / 4; i += blockDim.x)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = seg_begin[s];
  const int nsub = B / kRows;
  const int nstage = (seg_end[s] - k0) * nsub;
  // this warp's stages: st = warp + i * kWarps, i in [0, mine)
  const int mine = nstage > warp ? (nstage - warp + kWarps - 1) / kWarps : 0;
  int ids = 0;  // lane l: chunk of the warp's stage (i & ~31) + l

  auto issue = [&](int i) {
    if (i < mine) {
      if ((i & 31) == 0) {
        const int st = warp + (i + lane) * kWarps;
        ids = st < nstage ? chunks[k0 + st / nsub] : 0;
      }
      const int st = warp + i * kWarps;
      const int c = __shfl_sync(0xffffffffu, ids, i & 31);
      const long long row0 = (long long)c * B + (long long)(st % nsub) * kRows;
      const int slot = warp * kDepth + i % kDepth;
      copy16(smem_addr(smem + kXOff + (slot * kRows + 4 * lane) * 4), x + row0 + 4 * lane);
      copy16(smem_addr(smem + kYOff + (slot * kRows + 4 * lane) * 4), y + row0 + 4 * lane);
      if (kWeighted)
        copy16(smem_addr(smem + kWOff + (slot * kRows + 4 * lane) * 4),
               weight + row0 + 4 * lane);
      if (lane < kRows / 16)
        copy16(smem_addr(smem + kMOff + slot * kRows + 16 * lane), mask + row0 + 16 * lane);
    }
    copy_commit();  // an empty group past the end keeps the count uniform
  };

  for (int i = 0; i < kDepth - 1; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    issue(i + kDepth - 1);
    copy_wait();  // stage i's group has landed (this lane's part)
    __syncwarp();  // ... and every lane's
    const int slot = warp * kDepth + i % kDepth;
    const uchar4 m4 = reinterpret_cast<const uchar4*>(smem + kMOff + slot * kRows)[lane];
    const float4 x4 = reinterpret_cast<const float4*>(smem + kXOff + slot * kRows * 4)[lane];
    const float4 y4 = reinterpret_cast<const float4*>(smem + kYOff + slot * kRows * 4)[lane];
    float4 w4 = make_float4(1.f, 1.f, 1.f, 1.f);
    if (kWeighted)
      w4 = reinterpret_cast<const float4*>(smem + kWOff + slot * kRows * 4)[lane];
    __syncwarp();  // the slot is read before the next issue refills it
    bin4<kWeighted>(m4, x4, y4, w4, g, smem);
  }

  // every block's tile is complete; block `rank` sums its share of cells
  // over the cluster's peers in peer order and stores it
  cluster.sync();
  for (int q = threadIdx.x; q < share / 4; q += blockDim.x) {
    const int cell = cell0 + 4 * q;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (kWeighted) {
      for (int p = 0; p < kCluster; ++p) {
        const float4 a = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(reinterpret_cast<float*>(smem), p))[cell / 4];
        v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
      }
    } else {
      unsigned u[4] = {0u, 0u, 0u, 0u};
      for (int p = 0; p < kCluster; ++p) {
        const uint4 a = reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(reinterpret_cast<unsigned*>(smem), p))[cell / 4];
        u[0] += a.x; u[1] += a.y; u[2] += a.z; u[3] += a.w;
      }
      for (int i = 0; i < 4; ++i) v[i] = (float)u[i];
    }
    const int gy = g.oy + cell / kTile;
    for (int i = 0; i < 4; ++i) {
      const int gx = g.ox + cell % kTile + i;
      if (gx < width && gy < height) grid[(long long)gy * width + gx] = v[i];
    }
  }
  cluster.sync();  // peers keep their shared memory until all have read it
}

template <bool kWeighted>
int launch(const float* x, const float* y, const unsigned char* mask,
           const float* weight, int B, const int* seg_tile,
           const int* seg_begin, const int* seg_end, const int* chunks,
           int nseg, int ntx, float x0, float y0, float dx, float dy,
           int width, int height, float* grid, cudaStream_t stream) {
  // set once per instantiation (a function-local static is initialised once)
  static const cudaError_t e = cudaFuncSetAttribute(
      density_grouped_kernel<kWeighted>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  density_grouped_kernel<kWeighted><<<nseg, kThreads, kSmemBytes, stream>>>(
      x, y, mask, weight, B, seg_tile, seg_begin, seg_end, chunks, ntx, x0, y0,
      dx, dy, width, height, grid);
  return (int)cudaGetLastError();
}

}  // namespace

// The schedule's cluster size: segments come in runs of this many per tile.
extern "C" int gm_density_grouped_cluster() { return kCluster; }

// x, y: [C, B] f32; mask: [C, B] bytes (0/1); weight: [C, B] f32 or null;
// every pointer 16-byte aligned and B a multiple of 128. Segments s in
// [0, nseg), nseg a multiple of kCluster, in runs of kCluster per tile:
// tile seg_tile[s] over chunks[seg_begin[s] .. seg_end[s]). Every tile of
// the [height, width] f32 grid has its run; the kernel writes every cell.
// Returns cudaGetLastError() (or the attribute call's error).
extern "C" int gm_density_grouped_launch(
    const float* x, const float* y, const unsigned char* mask,
    const float* weight, int B, const int* seg_tile, const int* seg_begin,
    const int* seg_end, const int* chunks, int nseg, int ntx, float x0,
    float y0, float dx, float dy, int width, int height, float* grid,
    cudaStream_t stream) {
  if (nseg <= 0) return 0;
  if (nseg % kCluster != 0 || B % kRows != 0) return (int)cudaErrorInvalidValue;
  if (weight != nullptr)
    return launch<true>(x, y, mask, weight, B, seg_tile, seg_begin, seg_end,
                        chunks, nseg, ntx, x0, y0, dx, dy, width, height, grid,
                        stream);
  return launch<false>(x, y, mask, weight, B, seg_tile, seg_begin, seg_end,
                       chunks, nseg, ntx, x0, y0, dx, dy, width, height, grid,
                       stream);
}
