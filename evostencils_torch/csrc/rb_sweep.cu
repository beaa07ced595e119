// Fused red-black collective-Jacobi step for a scalar 2D real constant
// stencil with zero Dirichlet exterior, in float32, for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of evostencils_tpu/ops/pallas_kernels.py:
// the whole-array `_rb_sweep_kernel` (called through `_rb_sweep_call`) and
// the row-blocked `_rb_blocked_kernel` (called through `_rb_blocked_call`).
// The TPU needed two because of its VMEM size; here one tiled kernel serves
// every grid size.
//
// Semantics (the masked two-sweep of evostencils_tpu/backend/lowering.py):
//   red   = (row + col) even, on interior indices starting at 0
//   u'  = u  + where(red,   w * (f - A u ), 0)     w = omega * inv_diag
//   u'' = u' + where(black, w * (f - A u'), 0)
// Each colour is Jacobi: every residual of a colour reads only values from
// before that colour.  A 9-point stencil couples same-colour diagonal
// neighbours, so the kernel never updates in place inside one colour.
//
// What bounds it.  The least traffic is 12 bytes a point (read u and f,
// write the result once); the stencil costs 2 flops an entry a colour, far
// below the card's float32 rate, so bytes set the bound: 0.94 us at 511²
// and 3.75 us at 1023² over 3.35 TB/s.  The levels 63²-255² move under
// 0.8 MB, so there the launch (an empty kernel takes about 1.8 us back to
// back) and one block's serial path (load, red, barrier, black, store)
// bound it, not bytes: a block's serial path must hold one memory latency
// and few instructions.  At 511² and 1023² the instructions a point and
// the halo re-reads decide how close the kernel comes to the bytes.
//
// Design:
// * Radius as a template parameter R in {1, 2, 4}: the halo is sized for
//   the stencil (the main path's 5-point stencil stages 2R = 2 extra rows
//   and columns of u, not 8).  The wrapper picks the smallest R that
//   covers the stencil (ops/rb_sweep.py: template_radius).
// * The stencil is passed by value as a dense (2R+1)² grid of coefficients
//   and a bit mask of the entries present.  The entry loop unrolls with
//   compile-time shared-memory offsets; the main path's 5-point stencil
//   has instances of its own, with no mask test at all (5-6 % faster than
//   the mask at every level on an H100, PERF.md).
// * A block's red region is 32 columns wide, one lane a column while
//   staging; its output tile is the 32 - 2R columns inside it.  No thread
//   divides or takes a remainder.  Each stage's loop has a compile-time
//   trip count and is unrolled, so a thread starts all its loads before it
//   waits on any: the block's serial path holds one memory latency.
// * In the two half-sweeps a warp takes two rows at a time and each lane
//   one point of the colour being updated, so no lane idles on the other
//   colour and the two half-warps hit the two parities of the banks.
// * Red results go to their own buffer; the black update reads each
//   neighbour from it or from old u according to the parity of its offset,
//   known at compile time.  Blocks recompute their halo's red values, so
//   no block depends on another, and `out` is never `u`.
// * Tile height from the grid size (launch_shape): two block shapes, each
//   the fastest of seven timed at its levels.
// * omega stays a device pointer, for a later CUDA graph.
// * A batch of same-shape members (the group path's vmap, where the TPU's
//   Pallas calls get a batch axis prepended to their grid) is one launch
//   with gridDim.z = batch: block z reads and writes member z at offset
//   z * rows * cols and takes omega[z].  A member's arithmetic is the
//   single launch's, so the batch gives the bits of its single launches.
// Not done: vector loads and TMA need 16-byte aligned rows, and every level
// width is 2^k - 1; padding the port's array layout would change every op.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_SIDE = 9;  // 2 * 4 + 1: the largest radius is 4
constexpr int MAX_ENTRIES = MAX_SIDE * MAX_SIDE;
// The largest batch: the reference's largest group bucket.
constexpr int MAX_BATCH = 16;

// The stencil by value: value[(di + R) * (2R + 1) + (dj + R)] for the entry
// at row offset di and column offset dj, present[k / 32] bit k % 32 set
// where the stencil has an entry (an explicit zero keeps its product).
template <int R>
struct Coefficients {
  static constexpr int SIDE = 2 * R + 1;
  static constexpr int COUNT = SIDE * SIDE;
  float value[COUNT];
  uint32_t present[(COUNT + 31) / 32];
};

// Which entries are present: known at compile time for the main path's
// 5-point stencil (STAR, radius 1); GENERIC reads the bit mask.
enum Pattern { GENERIC, STAR };

template <int R, Pattern P>
__device__ __forceinline__ bool has_entry(const Coefficients<R>& a, int k) {
  if constexpr (P == STAR) {
    constexpr int SIDE = 2 * R + 1;
    const int di = k / SIDE - R, dj = k % SIDE - R;
    return di * di + dj * dj <= 1;
  } else {
    return (a.present[k / 32] >> (k % 32)) & 1u;
  }
}

// One block: the output tile of TILE_ROWS rows and 32 - 2R columns inside a
// red region of TILE_ROWS + 2R rows and 32 columns.  In the two half-sweeps
// a warp takes two rows at a time, lanes 0-15 the first and 16-31 the
// second, each lane one point of the colour being updated (its column
// parity follows the row), so no lane idles on a point of the other colour
// and the two half-warps hit the two parities of shared-memory banks.
template <int R, Pattern P, int TILE_ROWS, int WARPS>
__global__ void __launch_bounds__(WARP * WARPS)
rb_sweep_kernel(const float* __restrict__ u, const float* __restrict__ f,
                float* __restrict__ out, const float* __restrict__ omega,
                const Coefficients<R> a, float inv_diag, int rows, int cols) {
  constexpr int SIDE = 2 * R + 1;
  constexpr int RED_ROWS = TILE_ROWS + 2 * R;  // red points the black update reads
  constexpr int U_ROWS = TILE_ROWS + 4 * R;    // old u those red points read
  constexpr int U_COLS = WARP + 2 * R;
  __shared__ float s_u[U_ROWS][U_COLS];
  __shared__ float s_f[RED_ROWS][WARP];
  __shared__ float s_red[RED_ROWS][WARP];

  const ptrdiff_t member = static_cast<ptrdiff_t>(blockIdx.z) * rows * cols;
  u += member;
  f += member;
  out += member;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int row0 = blockIdx.y * TILE_ROWS;
  // Red-region column c is global column col0 - R + c, row r is row0 - R + r.
  const int col0 = blockIdx.x * (WARP - 2 * R);
  const float w = __ldg(omega + blockIdx.z) * inv_diag;

  // Stage u over the red region plus R and f over the red region, zero
  // outside the domain.  Loads first, then the stores, so that all of a
  // thread's loads are in flight together.
  {
    constexpr int U_STEPS = (U_ROWS + WARPS - 1) / WARPS;
    constexpr int F_STEPS = (RED_ROWS + WARPS - 1) / WARPS;
    float head[U_STEPS], tail[U_STEPS], fv[F_STEPS];
    const int gj_head = col0 - 2 * R + lane;  // u column lane
    const int gj_tail = gj_head + WARP;       // u column lane + 32, lanes < 2R
    const int gj_f = col0 - R + lane;
    const bool head_in = static_cast<unsigned>(gj_head) < static_cast<unsigned>(cols);
    const bool tail_in = lane < 2 * R && gj_tail < cols;
    const bool f_in = static_cast<unsigned>(gj_f) < static_cast<unsigned>(cols);
#pragma unroll
    for (int s = 0; s < U_STEPS; ++s) {
      const int r = warp + s * WARPS;
      const int gi = row0 - 2 * R + r;
      const bool row_in = r < U_ROWS && static_cast<unsigned>(gi) < static_cast<unsigned>(rows);
      const float* row = u + static_cast<ptrdiff_t>(gi) * cols;
      head[s] = row_in && head_in ? __ldg(row + gj_head) : 0.0f;
      tail[s] = row_in && tail_in ? __ldg(row + gj_tail) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < F_STEPS; ++s) {
      const int r = warp + s * WARPS;
      const int gi = row0 - R + r;
      const bool in = r < RED_ROWS && static_cast<unsigned>(gi) < static_cast<unsigned>(rows);
      fv[s] = in && f_in ? __ldg(f + static_cast<ptrdiff_t>(gi) * cols + gj_f) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < U_STEPS; ++s) {
      const int r = warp + s * WARPS;
      if (r < U_ROWS) {
        s_u[r][lane] = head[s];
        if (lane < 2 * R) s_u[r][lane + WARP] = tail[s];
      }
    }
#pragma unroll
    for (int s = 0; s < F_STEPS; ++s) {
      const int r = warp + s * WARPS;
      if (r < RED_ROWS) s_f[r][lane] = fv[s];
    }
  }
  __syncthreads();

  const int half = lane >> 4;
  const int pair = 2 * (lane & 15);  // the lane's even column of a pair

  // Red half-sweep on the red region, from old u only.  Red points outside
  // the domain are zero: the black update reads them as Dirichlet values.
  // Black points of this buffer are never read.
#pragma unroll
  for (int s = 0; s < (RED_ROWS + 2 * WARPS - 1) / (2 * WARPS); ++s) {
    const int r = 2 * (warp + s * WARPS) + half;
    if (r < RED_ROWS) {
      const int gi = row0 - R + r;
      const int c = pair + ((gi + col0 - R) & 1);  // (gi + gj) even
      const int gj = col0 - R + c;
      float v = 0.0f;
      if (static_cast<unsigned>(gi) < static_cast<unsigned>(rows) &&
          static_cast<unsigned>(gj) < static_cast<unsigned>(cols)) {
        float au = 0.0f;
#pragma unroll
        for (int k = 0; k < SIDE * SIDE; ++k) {
          if (has_entry<R, P>(a, k)) au = fmaf(a.value[k], s_u[r + k / SIDE][c + k % SIDE], au);
        }
        v = s_u[r + R][c + R] + w * (s_f[r][c] - au);
      }
      s_red[r][c] = v;
    }
  }
  __syncthreads();

  // Black half-sweep on the output tile: a neighbour at an odd offset is
  // red (post-red value), at an even offset black (old u).  Each lane also
  // writes the red point beside its black one.
#pragma unroll
  for (int s = 0; s < (TILE_ROWS + 2 * WARPS - 1) / (2 * WARPS); ++s) {
    const int t = 2 * (warp + s * WARPS) + half;
    const int gi = row0 + t;
    if (t < TILE_ROWS && gi < rows) {
      const int r = t + R;
      const int cb = pair + ((gi + col0 - R + 1) & 1);  // (gi + gj) odd
      const int cr = cb ^ 1;
      float* out_row = out + static_cast<ptrdiff_t>(gi) * cols;
      const int gjb = col0 - R + cb, gjr = col0 - R + cr;
      if (cb >= R && cb < WARP - R && gjb < cols) {
        float au = 0.0f;
#pragma unroll
        for (int k = 0; k < SIDE * SIDE; ++k) {
          const int di = k / SIDE - R, dj = k % SIDE - R;
          if (has_entry<R, P>(a, k)) {
            const float x = ((di + dj) & 1) ? s_red[r + di][cb + dj]
                                            : s_u[r + R + di][cb + R + dj];
            au = fmaf(a.value[k], x, au);
          }
        }
        out_row[gjb] = s_u[r + R][cb + R] + w * (s_f[r][cb] - au);
      }
      if (cr >= R && cr < WARP - R && gjr < cols) out_row[gjr] = s_red[r][cr];
    }
  }
}

template <int R, Pattern P, int TILE_ROWS, int WARPS>
cudaError_t launch(const float* u, const float* f, float* out, const float* omega,
                   const Coefficients<R>& a, float inv_diag, int batch, int rows, int cols,
                   cudaStream_t stream) {
  constexpr int TILE_COLS = WARP - 2 * R;
  const dim3 block(WARP, WARPS);
  const dim3 grid((cols + TILE_COLS - 1) / TILE_COLS, (rows + TILE_ROWS - 1) / TILE_ROWS,
                  batch);
  rb_sweep_kernel<R, P, TILE_ROWS, WARPS>
      <<<grid, block, 0, stream>>>(u, f, out, omega, a, inv_diag, rows, cols);
  return cudaGetLastError();
}

// The block shape from the grid size: 8-row tiles of 8 warps up to 256²
// cells, many short blocks for few points; 12-row tiles of 4 warps above,
// fewer halo rows re-read per output row.  Each was the fastest of seven
// shapes timed at every level of the main path on an H100 (PERF.md).
template <int R, Pattern P>
cudaError_t launch_shape(const float* u, const float* f, float* out, const float* omega,
                         const Coefficients<R>& a, float inv_diag, int batch, int rows,
                         int cols, cudaStream_t stream) {
  if (static_cast<long long>(rows) * cols <= 256 * 256) {
    return launch<R, P, 8, 8>(u, f, out, omega, a, inv_diag, batch, rows, cols, stream);
  }
  return launch<R, P, 12, 4>(u, f, out, omega, a, inv_diag, batch, rows, cols, stream);
}

// The stencil's coefficients for radius R out of the 9 x 9 host arrays, and
// the launch with the pattern known at compile time where there is one.
template <int R>
cudaError_t launch_radius(const float* u, const float* f, float* out, const float* omega,
                          const float* dense, const uint32_t* present, float inv_diag,
                          int batch, int rows, int cols, cudaStream_t stream) {
  Coefficients<R> a;
  bool star = true;
  for (int k = 0; k < Coefficients<R>::COUNT; ++k) {
    const int di = k / Coefficients<R>::SIDE - R, dj = k % Coefficients<R>::SIDE - R;
    const int m = (di + 4) * MAX_SIDE + (dj + 4);
    const bool has = (present[m / 32] >> (m % 32)) & 1u;
    a.value[k] = dense[m];
    if (k % 32 == 0) a.present[k / 32] = 0;
    if (has) a.present[k / 32] |= 1u << (k % 32);
    star = star && has == (di * di + dj * dj <= 1);
  }
  if constexpr (R == 1) {
    if (star) {
      return launch_shape<R, STAR>(u, f, out, omega, a, inv_diag, batch, rows, cols, stream);
    }
  }
  return launch_shape<R, GENERIC>(u, f, out, omega, a, inv_diag, batch, rows, cols, stream);
}

}  // namespace

namespace {

int dispatch(const float* u, const float* f, float* out, const float* omega, const float* dense,
             const uint32_t* present, int radius, float inv_diag, int batch, int rows, int cols,
             cudaStream_t stream) {
  if (batch <= 0 || batch > MAX_BATCH || rows <= 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int m = 0; m < MAX_ENTRIES; ++m) {
    const int di = m / MAX_SIDE - 4, dj = m % MAX_SIDE - 4;
    const bool has = (present[m / 32] >> (m % 32)) & 1u;
    if (has && (di < -radius || di > radius || dj < -radius || dj > radius)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaError_t err = cudaErrorInvalidValue;
  switch (radius) {
    case 1:
      err = launch_radius<1>(u, f, out, omega, dense, present, inv_diag, batch, rows, cols,
                             stream);
      break;
    case 2:
      err = launch_radius<2>(u, f, out, omega, dense, present, inv_diag, batch, rows, cols,
                             stream);
      break;
    case 4:
      err = launch_radius<4>(u, f, out, omega, dense, present, inv_diag, batch, rows, cols,
                             stream);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

}  // namespace

// u, f, out: rows x cols row-major float32 on the device; out must not
// alias u.  omega: one float on the device.  dense: 81 floats in host
// memory, the stencil's coefficient at row offset di and column offset dj
// in dense[(di + 4) * 9 + (dj + 4)]; present: 3 words in host memory, bit
// k % 32 of word k / 32 set where the stencil has the entry k.  radius
// (1, 2 or 4) must cover every entry.  Launches on `stream` without
// synchronising and returns cudaGetLastError(), or cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int rb_sweep_f32(const float* u, const float* f, float* out, const float* omega,
                            const float* dense, const uint32_t* present, int radius,
                            float inv_diag, int rows, int cols, cudaStream_t stream) {
  return dispatch(u, f, out, omega, dense, present, radius, inv_diag, 1, rows, cols, stream);
}

// The same step for `batch` members (1 to MAX_BATCH) in one launch: u, f,
// out are batch x rows x cols row-major, member b at offset b * rows * cols,
// omega holds batch floats on the device, member b's at omega[b].  The rest
// as rb_sweep_f32.
extern "C" int rb_sweep_f32_batched(const float* u, const float* f, float* out,
                                    const float* omega, const float* dense,
                                    const uint32_t* present, int radius, float inv_diag,
                                    int batch, int rows, int cols, cudaStream_t stream) {
  return dispatch(u, f, out, omega, dense, present, radius, inv_diag, batch, rows, cols, stream);
}
