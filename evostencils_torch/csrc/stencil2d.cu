// A real constant 2D stencil through a lattice map, in one launch, for
// Hopper (sm_90a): the port's stencil application, restriction and
// prolongation of ops/stencil_ops.py and ops/intergrid.py.
//
// The reference computes each of these as one XLA-fused op (no Pallas
// call); the port's plain torch form is a chain of launches: a zero-padded
// copy, one scalar-times-shifted-view multiply per entry and one add per
// entry after the first (11 launches for a 5-point operator, about 19 for a
// full-weighting restriction, 21 for a bilinear prolongation with its
// injection).  This kernel computes the same sum in one launch.
//
// Modes, for the output point (i, j) and the entry (di, dj, w):
//   APPLY     y[i, j]       += w * u[i + di, j + dj]
//   RESTRICT  coarse[i, j]  += w * fine[c0 (i + 1) - 1 + di, c1 (j + 1) - 1 + dj]
//   PROLONG   fine[i, j]    += w * inj[i + di, j + dj], where inj[z0, z1] is
//             coarse[(z0 + 1) / c0 - 1, (z1 + 1) / c1 - 1] at z0 = -1 mod c0
//             and z1 = -1 mod c1, and 0 elsewhere (the injection's zeros)
// with every point outside the input grid read as 0 (the zero padding).
//
// Same bits as the chain it replaces: the terms are summed in the stencil's
// entry order, the first product is the sum's start value, each product
// and each sum is rounded on its own (__fmul_rn / __fadd_rn, __dmul_rn /
// __dadd_rn: no FMA contraction), and a point outside the grid or off the
// lattice contributes w * 0.0 in its place in the order, so signed zeros,
// infinities and NaNs come out as the chain's do.  The wrapper rounds w to
// the tensor's dtype as torch rounds a Python scalar.
//
// What bounds it: launches and bytes, not arithmetic.  The largest call of
// the main path moves 8-12 bytes a point at 511² (0.6-0.9 us over 3.35
// TB/s) against a launch floor of about 1.8 us, so one thread an output
// point in blocks whose rows are one warp wide (coalesced loads through
// L1/L2) is enough: no shared-memory tiling.  A thread issues all of its
// loads before the first product, so its serial path holds one memory
// latency; the entry loop is unrolled to the smallest instantiated count
// that covers the stencil.
//
// The entries travel by value in the kernel's parameters, so a CUDA-graph
// capture records them and no host-to-device copy is made.  A batch of
// same-shape members, (B, rows, cols), is one launch with gridDim.z = B.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_ENTRIES = 25;
constexpr int MAX_RADIUS = 4;
constexpr int MAX_BATCH = 65535;  // gridDim.z
constexpr int BLOCK_COLS = 32;
constexpr int BLOCK_ROWS = 8;

enum Mode { APPLY = 0, RESTRICT = 1, PROLONG = 2 };

template <typename T>
struct Entries {
  int count;
  int di[MAX_ENTRIES];
  int dj[MAX_ENTRIES];
  T w[MAX_ENTRIES];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ bool inside(int z, int n) {
  return static_cast<unsigned>(z) < static_cast<unsigned>(n);
}

// The input value entry (di, dj) reads for the output point (i, j), 0 where
// the padded or injected field holds a zero.  c0 and c1 are compile-time
// constants in the instances for factor 2 (the lattice test and the
// coarse index are then a bit test and a shift, not divisions).
template <typename T, Mode M>
__device__ __forceinline__ T term_input(const T* __restrict__ in, int i, int j, int di, int dj,
                                        int in_rows, int in_cols, int out_rows, int out_cols,
                                        int c0, int c1) {
  if constexpr (M == APPLY) {
    const int zi = i + di, zj = j + dj;
    return inside(zi, in_rows) && inside(zj, in_cols)
               ? __ldg(in + static_cast<ptrdiff_t>(zi) * in_cols + zj) : T(0);
  } else if constexpr (M == RESTRICT) {
    const int zi = c0 * (i + 1) - 1 + di, zj = c1 * (j + 1) - 1 + dj;
    return inside(zi, in_rows) && inside(zj, in_cols)
               ? __ldg(in + static_cast<ptrdiff_t>(zi) * in_cols + zj) : T(0);
  } else {
    const int zi = i + di, zj = j + dj;
    if (!inside(zi, out_rows) || !inside(zj, out_cols)) return T(0);
    // zi, zj >= 0 here: unsigned division, which a factor of 2 makes a shift.
    const unsigned ni = zi + 1, nj = zj + 1, ui = c0, uj = c1;
    if (ni % ui != 0 || nj % uj != 0) return T(0);
    const int ci = static_cast<int>(ni / ui) - 1, cj = static_cast<int>(nj / uj) - 1;
    return inside(ci, in_rows) && inside(cj, in_cols)
               ? __ldg(in + static_cast<ptrdiff_t>(ci) * in_cols + cj) : T(0);
  }
}

// One thread an output point; N >= e.count, the unrolled entry count; C > 0
// fixes both coarsening factors at compile time, C = 0 reads c0 and c1.
template <typename T, Mode M, int N, int C>
__global__ void __launch_bounds__(BLOCK_COLS * BLOCK_ROWS)
stencil2d_kernel(const T* __restrict__ in, T* __restrict__ out, const Entries<T> e,
                 int in_rows, int in_cols, int out_rows, int out_cols, int c0, int c1) {
  if constexpr (C > 0) {
    c0 = C;
    c1 = C;
  }
  const int j = blockIdx.x * BLOCK_COLS + threadIdx.x;
  const int i = blockIdx.y * BLOCK_ROWS + threadIdx.y;
  if (i >= out_rows || j >= out_cols) return;
  in += static_cast<ptrdiff_t>(blockIdx.z) * in_rows * in_cols;
  out += static_cast<ptrdiff_t>(blockIdx.z) * out_rows * out_cols;
  T x[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[k] = k < e.count ? term_input<T, M>(in, i, j, e.di[k], e.dj[k], in_rows, in_cols,
                                          out_rows, out_cols, c0, c1)
                       : T(0);
  }
  T acc = mul_rn(e.w[0], x[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) {
    if (k < e.count) acc = add_rn(acc, mul_rn(e.w[k], x[k]));
  }
  out[static_cast<ptrdiff_t>(i) * out_cols + j] = acc;
}

template <typename T, Mode M, int N>
cudaError_t launch(const T* in, T* out, const Entries<T>& e, int batch, int in_rows,
                   int in_cols, int out_rows, int out_cols, int c0, int c1,
                   cudaStream_t stream) {
  const dim3 block(BLOCK_COLS, BLOCK_ROWS);
  const dim3 grid((out_cols + BLOCK_COLS - 1) / BLOCK_COLS,
                  (out_rows + BLOCK_ROWS - 1) / BLOCK_ROWS, batch);
  if constexpr (M == APPLY) {
    stencil2d_kernel<T, M, N, 1>
        <<<grid, block, 0, stream>>>(in, out, e, in_rows, in_cols, out_rows, out_cols, c0, c1);
  } else if (c0 == 2 && c1 == 2) {
    stencil2d_kernel<T, M, N, 2>
        <<<grid, block, 0, stream>>>(in, out, e, in_rows, in_cols, out_rows, out_cols, c0, c1);
  } else {
    stencil2d_kernel<T, M, N, 0>
        <<<grid, block, 0, stream>>>(in, out, e, in_rows, in_cols, out_rows, out_cols, c0, c1);
  }
  return cudaGetLastError();
}

// The smallest unrolled count that covers the stencil: 5 for the 5-point
// operator, 9 for the transfer stencils and 9-point operators, 25 above.
template <typename T, Mode M>
cudaError_t launch_count(const T* in, T* out, const Entries<T>& e, int batch, int in_rows,
                         int in_cols, int out_rows, int out_cols, int c0, int c1,
                         cudaStream_t stream) {
  if (e.count <= 5) {
    return launch<T, M, 5>(in, out, e, batch, in_rows, in_cols, out_rows, out_cols, c0, c1,
                           stream);
  }
  if (e.count <= 9) {
    return launch<T, M, 9>(in, out, e, batch, in_rows, in_cols, out_rows, out_cols, c0, c1,
                           stream);
  }
  return launch<T, M, MAX_ENTRIES>(in, out, e, batch, in_rows, in_cols, out_rows, out_cols,
                                   c0, c1, stream);
}

template <typename T>
int dispatch(int mode, const T* in, T* out, const int* offsets, const T* weights, int count,
             int batch, int in_rows, int in_cols, int out_rows, int out_cols, int c0, int c1,
             cudaStream_t stream) {
  if (count < 1 || count > MAX_ENTRIES || batch < 1 || batch > MAX_BATCH || in_rows < 1 ||
      in_cols < 1 || out_rows < 1 || out_cols < 1 || c0 < 1 || c1 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Entries<T> e = {};
  e.count = count;
  for (int k = 0; k < count; ++k) {
    const int di = offsets[2 * k], dj = offsets[2 * k + 1];
    if (di < -MAX_RADIUS || di > MAX_RADIUS || dj < -MAX_RADIUS || dj > MAX_RADIUS) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    e.di[k] = di;
    e.dj[k] = dj;
    e.w[k] = weights[k];
  }
  cudaError_t err = cudaErrorInvalidValue;
  switch (mode) {
    case APPLY:
      err = launch_count<T, APPLY>(in, out, e, batch, in_rows, in_cols, out_rows, out_cols, c0,
                                   c1, stream);
      break;
    case RESTRICT:
      err = launch_count<T, RESTRICT>(in, out, e, batch, in_rows, in_cols, out_rows, out_cols,
                                      c0, c1, stream);
      break;
    case PROLONG:
      err = launch_count<T, PROLONG>(in, out, e, batch, in_rows, in_cols, out_rows, out_cols,
                                     c0, c1, stream);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

}  // namespace

// mode: 0 apply, 1 restrict, 2 prolong.  in: batch x in_rows x in_cols and
// out: batch x out_rows x out_cols, row-major float32 on the device, member
// b at offset b * rows * cols; out must not alias in.  offsets: 2 * count
// ints in host memory, (di, dj) of entry k at offsets[2k], offsets[2k + 1],
// each within [-4, 4]; weights: count floats in host memory, in the same
// order, 1 <= count <= 25.  c0, c1: the coarsening factors of restrict and
// prolong (apply ignores them).  Launches on `stream` without synchronising
// and returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it
// does not take.
extern "C" int stencil2d_f32(int mode, const float* in, float* out, const int* offsets,
                             const float* weights, int count, int batch, int in_rows,
                             int in_cols, int out_rows, int out_cols, int c0, int c1,
                             cudaStream_t stream) {
  return dispatch<float>(mode, in, out, offsets, weights, count, batch, in_rows, in_cols,
                         out_rows, out_cols, c0, c1, stream);
}

// The same in float64.
extern "C" int stencil2d_f64(int mode, const double* in, double* out, const int* offsets,
                             const double* weights, int count, int batch, int in_rows,
                             int in_cols, int out_rows, int out_cols, int c0, int c1,
                             cudaStream_t stream) {
  return dispatch<double>(mode, in, out, offsets, weights, count, batch, in_rows, in_cols,
                          out_rows, out_cols, c0, c1, stream);
}
