// Block-level dense Cholesky factor and solve in shared memory, used by the
// fused contact and stable-PD solves (fused_contact.cu, K3 and K4); the
// batched SPD solve (spd_solve.cu, K2) has its own one-warp factor and
// takes only the math helpers and opt_in_shared from here.
//
// Both functions are called by every thread of a block and work on one
// system in shared memory, row-major.  They are the counterparts of
// egopose_tpu/physics/linalg_pallas.py::_factor_blocked (right-looking,
// every pivot floored at 1e-12 before its reciprocal square root) and
// _subst_blocked (forward then backward substitution): the arithmetic, not
// the TPU's 128-lane layout or its 8-column panels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

__device__ inline float xrsqrt(float x) { return rsqrtf(x); }
__device__ inline double xrsqrt(double x) { return rsqrt(x); }
__device__ inline float xmax(float a, float b) { return fmaxf(a, b); }
__device__ inline double xmax(double a, double b) { return fmax(a, b); }
__device__ inline float xmin(float a, float b) { return fminf(a, b); }
__device__ inline double xmin(double a, double b) { return fmin(a, b); }
__device__ inline float xabs(float x) { return fabsf(x); }
__device__ inline double xabs(double x) { return fabs(x); }

// A (n x n) = L L^T in place: L in the lower triangle, the strict upper
// triangle untouched.  dinv: n scratch values.  At stage j every thread
// reads the pivot A[j][j] (final after stage j-1) and updates its share of
// the trailing lower triangle, A[i][k] -= (A[i][j] s)(A[k][j] s) with
// s = rsqrt(max(A[j][j], 1e-12)); column j itself is only read at stage j,
// so it is scaled after the loop, and one __syncthreads ends each stage.
template <typename T>
__device__ void block_cholesky(T* A, T* dinv, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < n; ++j) {
    const T s = xrsqrt(xmax(A[j * n + j], T(1e-12)));
    if (tid == 0) dinv[j] = s;
    const int m = n - j - 1;              // trailing block is m x m
    for (int e = tid; e < m * m; e += nt) {
      const int i = j + 1 + e / m, k = j + 1 + e % m;
      if (k <= i) A[i * n + k] -= (A[i * n + j] * s) * (A[k * n + j] * s);
    }
    __syncthreads();
  }
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, k = e % n;
    if (k <= i) A[e] *= dinv[k];
  }
  __syncthreads();
}

// X (n x r) <- (L L^T)^-1 X given L from block_cholesky.  The r columns are
// solved in parallel, rows x columns spread over the threads: at stage j
// the threads eliminate x_j from the rows it feeds; the division of row j
// by L[j][j] is done after each sweep.
template <typename T>
__device__ void block_cho_solve(const T* A, T* X, int n, int r) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // forward: L y = b
  for (int j = 0; j < n; ++j) {
    const T ljj = A[j * n + j];
    const int m = n - j - 1;
    for (int e = tid; e < m * r; e += nt) {
      const int i = j + 1 + e / r, c = e % r;
      X[i * r + c] -= A[i * n + j] * (X[j * r + c] / ljj);
    }
    __syncthreads();
  }
  for (int e = tid; e < n * r; e += nt) X[e] /= A[(e / r) * (n + 1)];
  __syncthreads();
  // backward: L^T x = y
  for (int j = n - 1; j >= 0; --j) {
    const T ljj = A[j * n + j];
    for (int e = tid; e < j * r; e += nt) {
      const int i = e / r, c = e % r;
      X[i * r + c] -= A[j * n + i] * (X[j * r + c] / ljj);
    }
    __syncthreads();
  }
  for (int e = tid; e < n * r; e += nt) X[e] /= A[(e / r) * (n + 1)];
  __syncthreads();
}

// Opt a kernel in to ``bytes`` of dynamic shared memory.  Returns 0, -2
// when the card's per-block limit is smaller, or a CUDA error code.
template <typename K>
static int opt_in_shared(K kernel, size_t bytes) {
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)max_optin) return -2;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
