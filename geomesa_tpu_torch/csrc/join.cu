// Spatial-join predicates: four kernels behind kernels/join.py.
//
// They replace the jitted XLA functions of the JAX package's join:
//
// * pair_tiles      - geomesa_tpu/planning/join_exec.py:486 (_pairs_kernel):
//   one block per tile computes the [Bp, Pp] verdicts of pair_mask with the
//   valid-row masks, an int32 count per tile, and the uint8 mask only when
//   the caller asks for it (a count-only join copies back counts alone);
// * pair_flat       - join_exec.py:532 (_brute_kernel): the same verdict
//   over a flat [Kp] candidate list, with a masked count;
// * polygon_verdict - join_exec.py:938 (_poly_kernel over polygon_mask):
//   [Np, Rp] verdicts of points against padded polygon tables: even-odd
//   parity per part, OR over each row's parts ("pip"), or inclusive box
//   containment ("poly_bbox");
// * pip_assign      - kernels/join.py::pip_assign under the executor for
//   geomesa_tpu/processes.py:403 (spatial_join): each masked point's lowest
//   polygon id with odd parity, else -1.
//
// The join's contract is bit-identity with the NumPy N*M brute force, so
// every verdict is computed with explicitly rounded intrinsics in the
// reference's op order: nvcc would otherwise contract ddx*ddx + ddy*ddy and
// x1 + (py - y1) * (x2 - x1) / denom into FMAs and move boundary verdicts.
// Compares are inclusive where the reference's are; a NaN coordinate never
// straddles an edge and never matches a pair.
//
// The polygon kernels walk an edge table in order with O(1) state per
// point (the current part or polygon and its parity bit), so each part's
// edges must be contiguous and, for pip_assign, in ascending polygon order;
// kernels/join.py checks that as it uploads a table. Padded edges (at 1e30)
// sit after the real ones and are not walked. These are the simple first
// versions: edges are read through the cache, not staged in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Pred { kBbox = 0, kDwithin = 1, kDwithinMeters = 2 };

// pair_mask's verdict for one pair, in the reference's f32 op order
__device__ __forceinline__ bool pair_verdict(int pred, float lx, float ly, float lz,
                                             float rx, float ry, float rz, float p0,
                                             float p1) {
  const float ddx = __fsub_rn(lx, rx);
  const float ddy = __fsub_rn(ly, ry);
  if (pred == kBbox) return (fabsf(ddx) <= p0) && (fabsf(ddy) <= p1);
  float s = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
  if (pred == kDwithinMeters) {
    const float ddz = __fsub_rn(lz, rz);
    s = __fadd_rn(s, __fmul_rn(ddz, ddz));
  }
  return s <= p0;
}

// crossing_matrix's indicator for one (point, edge): the upward ray from
// (px, py) crosses the edge iff it straddles py and px < the abscissa
__device__ __forceinline__ unsigned crosses(float px, float py, float x1, float y1,
                                            float x2, float y2) {
  const bool straddle = (y1 > py) != (y2 > py);
  float denom = __fsub_rn(y2, y1);
  if (denom == 0.0f) denom = 1.0f;
  const float xint = __fadd_rn(
      x1, __fdiv_rn(__fmul_rn(__fsub_rn(py, y1), __fsub_rn(x2, x1)), denom));
  return (straddle && (px < xint)) ? 1u : 0u;
}

// sum of v over the block, valid in thread 0
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int s_warp[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += s_warp[w];
  return total;
}

__global__ void __launch_bounds__(kThreads) pair_tiles_kernel(
    const float* __restrict__ lx, const float* __restrict__ ly,
    const float* __restrict__ lz, const float* __restrict__ rx,
    const float* __restrict__ ry, const float* __restrict__ rz,
    const int* __restrict__ lval, const int* __restrict__ rval, int Bp, int Pp, int pred,
    float p0, float p1, uint8_t* __restrict__ mask, int* __restrict__ counts) {
  const long long c = blockIdx.x;
  const int lv = lval[c], rv = rval[c];
  const int slots = Bp * Pp;
  const float* lxc = lx + c * Bp;
  const float* lyc = ly + c * Bp;
  const float* rxc = rx + c * Pp;
  const float* ryc = ry + c * Pp;
  int n = 0;
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    const int b = i / Pp, p = i - b * Pp;
    bool v = false;
    if (b < lv && p < rv) {
      const float a = lz ? lz[c * Bp + b] : 0.0f;
      const float z = rz ? rz[c * Pp + p] : 0.0f;
      v = pair_verdict(pred, lxc[b], lyc[b], a, rxc[p], ryc[p], z, p0, p1);
    }
    n += v ? 1 : 0;
    if (mask) mask[c * slots + i] = v ? 1 : 0;
  }
  const int total = block_sum(n);
  if (threadIdx.x == 0) counts[c] = total;
}

__global__ void __launch_bounds__(kThreads) pair_flat_kernel(
    const float* __restrict__ lx, const float* __restrict__ ly,
    const float* __restrict__ lz, const float* __restrict__ rx,
    const float* __restrict__ ry, const float* __restrict__ rz, long long kp,
    long long kvalid, int pred, float p0, float p1, uint8_t* __restrict__ mask,
    int* __restrict__ count) {
  int n = 0;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x; k < kp;
       k += (long long)gridDim.x * kThreads) {
    bool v = false;
    if (k < kvalid)
      v = pair_verdict(pred, lx[k], ly[k], lz ? lz[k] : 0.0f, rx[k], ry[k],
                       rz ? rz[k] : 0.0f, p0, p1);
    n += v ? 1 : 0;
    if (mask) mask[k] = v ? 1 : 0;
  }
  const int total = block_sum(n);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

// "pip": one thread per point walks the real edges part by part; a part's
// odd parity sets its row's verdict (out is zeroed by the caller)
__global__ void __launch_bounds__(kThreads) polygon_pip_kernel(
    const float* __restrict__ px, const float* __restrict__ py, long long n,
    const float* __restrict__ x1, const float* __restrict__ y1,
    const float* __restrict__ x2, const float* __restrict__ y2,
    const int* __restrict__ part_id, const int* __restrict__ part_row, int n_edges,
    int rp, uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || n_edges <= 0) return;
  const float x = px[i], y = py[i];
  uint8_t* row = out + i * rp;
  int cur = __ldg(part_id);
  unsigned parity = 0;
  for (int e = 0; e < n_edges; ++e) {
    const int pid = __ldg(part_id + e);
    if (pid != cur) {
      if (parity) row[__ldg(part_row + cur)] = 1;
      parity = 0;
      cur = pid;
    }
    parity ^= crosses(x, y, __ldg(x1 + e), __ldg(y1 + e), __ldg(x2 + e), __ldg(y2 + e));
  }
  if (parity) row[__ldg(part_row + cur)] = 1;
}

// "poly_bbox": one thread per (point, row) verdict
__global__ void __launch_bounds__(kThreads) polygon_bbox_kernel(
    const float* __restrict__ px, const float* __restrict__ py, long long n,
    const float* __restrict__ boxes, int rp, uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * rp) return;
  const long long p = i / rp;
  const int r = (int)(i - p * rp);
  const float x = px[p], y = py[p];
  const float4 b = reinterpret_cast<const float4*>(boxes)[r];
  out[i] = (x >= b.x && y >= b.y && x <= b.z && y <= b.w) ? 1 : 0;
}

// one thread per point: the first polygon (in id order) whose parity is
// odd; unmasked points get -1 without walking
__global__ void __launch_bounds__(kThreads) pip_assign_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const uint8_t* __restrict__ mask, long long n, const float* __restrict__ x1,
    const float* __restrict__ y1, const float* __restrict__ x2,
    const float* __restrict__ y2, const int* __restrict__ poly_id, int n_edges,
    int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int result = -1;
  if (mask[i] && n_edges > 0) {
    const float x = px[i], y = py[i];
    int cur = __ldg(poly_id);
    unsigned parity = 0;
    for (int e = 0; e < n_edges; ++e) {
      const int pid = __ldg(poly_id + e);
      if (pid != cur) {
        if (parity) break;
        cur = pid;
      }
      parity ^= crosses(x, y, __ldg(x1 + e), __ldg(y1 + e), __ldg(x2 + e), __ldg(y2 + e));
    }
    if (parity) result = cur;
  }
  out[i] = result;
}

unsigned blocks_for(long long work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

}  // namespace

// lx/ly/lz: [C, Bp] f32 left blocks (lz null unless dwithin_meters),
// rx/ry/rz: [C, Pp] right blocks, lval/rval: [C] int32 valid rows; mask:
// [C, Bp, Pp] bytes or null; counts: [C] int32. Returns cudaGetLastError().
extern "C" int gm_pair_tiles_launch(const float* lx, const float* ly, const float* lz,
                                    const float* rx, const float* ry, const float* rz,
                                    const int* lval, const int* rval, int C, int Bp,
                                    int Pp, int pred, float p0, float p1, uint8_t* mask,
                                    int* counts, cudaStream_t stream) {
  if (C <= 0) return 0;
  pair_tiles_kernel<<<(unsigned)C, kThreads, 0, stream>>>(
      lx, ly, lz, rx, ry, rz, lval, rval, Bp, Pp, pred, p0, p1, mask, counts);
  return (int)cudaGetLastError();
}

// [kp] f32 gathered sides, the first kvalid slots real; mask: kp bytes or
// null; count: one int32, zeroed by the caller.
extern "C" int gm_pair_flat_launch(const float* lx, const float* ly, const float* lz,
                                   const float* rx, const float* ry, const float* rz,
                                   long long kp, long long kvalid, int pred, float p0,
                                   float p1, uint8_t* mask, int* count,
                                   cudaStream_t stream) {
  if (kp <= 0) return 0;
  long long blocks = blocks_for(kp);
  if (blocks > 4096) blocks = 4096;
  pair_flat_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      lx, ly, lz, rx, ry, rz, kp, kvalid, pred, p0, p1, mask, count);
  return (int)cudaGetLastError();
}

// px/py: n f32 points; x1..y2, part_id: the edge table (first n_edges real,
// grouped by part); part_row: row of each part; boxes: [rp, 4] f32;
// pred 0 = pip, 1 = poly_bbox; out: [n, rp] bytes, zeroed by the caller.
extern "C" int gm_polygon_verdict_launch(const float* px, const float* py, long long n,
                                         const float* x1, const float* y1,
                                         const float* x2, const float* y2,
                                         const int* part_id, const int* part_row,
                                         int n_edges, const float* boxes, int rp, int pred,
                                         uint8_t* out, cudaStream_t stream) {
  if (n <= 0 || rp <= 0) return 0;
  if (pred == 0) {
    polygon_pip_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        px, py, n, x1, y1, x2, y2, part_id, part_row, n_edges, rp, out);
  } else {
    polygon_bbox_kernel<<<blocks_for(n * rp), kThreads, 0, stream>>>(px, py, n, boxes,
                                                                      rp, out);
  }
  return (int)cudaGetLastError();
}

// px/py: n f32 points, mask: n bytes; x1..y2, poly_id: the edge table, its
// first n_edges real and grouped by polygon in ascending id; out: n int32.
extern "C" int gm_pip_assign_launch(const float* px, const float* py, const uint8_t* mask,
                                    long long n, const float* x1, const float* y1,
                                    const float* x2, const float* y2, const int* poly_id,
                                    int n_edges, int* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  pip_assign_kernel<<<blocks_for(n), kThreads, 0, stream>>>(px, py, mask, n, x1, y1, x2,
                                                            y2, poly_id, n_edges, out);
  return (int)cudaGetLastError();
}
