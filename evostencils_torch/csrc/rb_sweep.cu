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
// Design: each thread block owns a TILE x TILE output tile.  It stages u
// over the tile plus 2*MAX_RADIUS and f over the tile plus MAX_RADIUS in
// shared memory (zero outside the domain), computes red on tile+MAX_RADIUS
// from old u into a second shared buffer, synchronises, computes black on
// the tile from that buffer, and writes the tile to `out`, which is never
// `u`.  Halo points are recomputed by neighbouring blocks, so no block
// depends on another.
//
// What bounds it: device-memory bandwidth.  The minimum traffic is 12 bytes
// per point (read u and f, write u once); the stencil costs 2 flops per
// entry per colour.  Halo re-reads mostly hit L1/L2.  Vectorised loads, TMA
// and temporal blocking over several steps are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int MAX_RADIUS = 4;
constexpr int MAX_ENTRIES = (2 * MAX_RADIUS + 1) * (2 * MAX_RADIUS + 1);
constexpr int RED_DIM = TILE + 2 * MAX_RADIUS;  // red points the tile's black update reads
constexpr int U_DIM = TILE + 4 * MAX_RADIUS;    // old u those red points read
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 8;
constexpr int THREADS = THREADS_X * THREADS_Y;

__global__ void __launch_bounds__(THREADS)
rb_sweep_kernel(const float* __restrict__ u, const float* __restrict__ f,
                float* __restrict__ out, const float* __restrict__ omega,
                const int* __restrict__ offsets, const float* __restrict__ values,
                int n_entries, float inv_diag, int rows, int cols) {
  __shared__ float s_u[U_DIM][U_DIM + 1];
  __shared__ float s_f[RED_DIM][RED_DIM + 1];
  __shared__ float s_red[RED_DIM][RED_DIM + 1];
  __shared__ int s_di[MAX_ENTRIES];
  __shared__ int s_dj[MAX_ENTRIES];
  __shared__ float s_val[MAX_ENTRIES];

  const int tid = threadIdx.y * THREADS_X + threadIdx.x;
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;

  for (int e = tid; e < n_entries; e += THREADS) {
    s_di[e] = offsets[2 * e];
    s_dj[e] = offsets[2 * e + 1];
    s_val[e] = values[e];
  }
  for (int k = tid; k < U_DIM * U_DIM; k += THREADS) {
    const int i = k / U_DIM, j = k % U_DIM;
    const int gi = row0 - 2 * MAX_RADIUS + i, gj = col0 - 2 * MAX_RADIUS + j;
    const bool inside = gi >= 0 && gi < rows && gj >= 0 && gj < cols;
    s_u[i][j] = inside ? u[(size_t)gi * cols + gj] : 0.0f;
  }
  for (int k = tid; k < RED_DIM * RED_DIM; k += THREADS) {
    const int i = k / RED_DIM, j = k % RED_DIM;
    const int gi = row0 - MAX_RADIUS + i, gj = col0 - MAX_RADIUS + j;
    const bool inside = gi >= 0 && gi < rows && gj >= 0 && gj < cols;
    s_f[i][j] = inside ? f[(size_t)gi * cols + gj] : 0.0f;
  }
  __syncthreads();

  const float w = omega[0] * inv_diag;

  // Red half-sweep on the tile plus MAX_RADIUS, from old u only.  Points
  // outside the domain stay zero: the black sweep reads them as Dirichlet.
  for (int k = tid; k < RED_DIM * RED_DIM; k += THREADS) {
    const int i = k / RED_DIM, j = k % RED_DIM;
    const int gi = row0 - MAX_RADIUS + i, gj = col0 - MAX_RADIUS + j;
    float v = 0.0f;
    if (gi >= 0 && gi < rows && gj >= 0 && gj < cols) {
      const int ui = i + MAX_RADIUS, uj = j + MAX_RADIUS;
      v = s_u[ui][uj];
      if (((gi + gj) & 1) == 0) {
        float au = 0.0f;
        for (int e = 0; e < n_entries; ++e) {
          au += s_val[e] * s_u[ui + s_di[e]][uj + s_dj[e]];
        }
        v += w * (s_f[i][j] - au);
      }
    }
    s_red[i][j] = v;
  }
  __syncthreads();

  // Black half-sweep on the tile, from the post-red values.
  for (int k = tid; k < TILE * TILE; k += THREADS) {
    const int i = k / TILE, j = k % TILE;
    const int gi = row0 + i, gj = col0 + j;
    if (gi >= rows || gj >= cols) continue;
    const int ri = i + MAX_RADIUS, rj = j + MAX_RADIUS;
    float v = s_red[ri][rj];
    if (((gi + gj) & 1) == 1) {
      float au = 0.0f;
      for (int e = 0; e < n_entries; ++e) {
        au += s_val[e] * s_red[ri + s_di[e]][rj + s_dj[e]];
      }
      v += w * (s_f[ri][rj] - au);
    }
    out[(size_t)gi * cols + gj] = v;
  }
}

}  // namespace

// u, f, out: rows x cols row-major float32 on the device; out must not
// alias u.  omega: one float on the device.  offsets: 2*n_entries ints
// (row, col) on the device, each |offset| <= 4; values: n_entries floats on
// the device.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int rb_sweep_f32(const float* u, const float* f, float* out,
                            const float* omega, const int* offsets,
                            const float* values, int n_entries, float inv_diag,
                            int rows, int cols, cudaStream_t stream) {
  if (n_entries < 0 || n_entries > MAX_ENTRIES || rows <= 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(THREADS_X, THREADS_Y);
  const dim3 grid((cols + TILE - 1) / TILE, (rows + TILE - 1) / TILE);
  rb_sweep_kernel<<<grid, block, 0, stream>>>(u, f, out, omega, offsets, values,
                                              n_entries, inv_diag, rows, cols);
  return static_cast<int>(cudaGetLastError());
}
