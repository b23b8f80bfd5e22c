// Batched dense SPD solve A X = B by Cholesky for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel egopose_tpu/physics/linalg_pallas.py::
// _cho_solve_kernel_blocked (launched by _batched_spd_solve_tpu through the
// custom_vmap rule of spd_solve).  It computes what that kernel computes --
// for each system b, factor A_b = L L^T with every pivot floored at 1e-12
// before its reciprocal square root, then forward and back substitution for
// the r right-hand-side columns -- not its 128-lane layout or its 8-column
// panels.  On the engine's path n = 58 (the humanoid's dofs) and
// r = 1 + 3K + KP = 25 (the dynamics force and the Delassus columns J^T),
// 15 launches per torque-mode control step (engine.torque_control_step), or
// r = 1 (the split path's PD and dynamics solves).
//
// Design.  One warp per system, up to four systems per block, and no block
// barrier: a warp synchronises with __syncwarp and shuffles only.  Per
// system, A (n x n, row stride n + 1), X (n x r) and the n reciprocal
// diagonals of L live in dynamic shared memory: at n = 58, r = 25 that is
// 19.5 KB in float, so four systems per block and 8 warps per SM, and
// B = 1024 runs in one wave on the H100's 132 SMs.  The factor is
// left-looking by column: lanes own rows (lane, lane + 32, ...) and form
// L[i][j] from a dot over k < j with L[j][k] read as a broadcast; the odd
// row stride puts the 32 rows a warp reads at once in 32 distinct banks.
// Each column takes one reciprocal square root of max(pivot, 1e-12), as
// 1 / sqrt (IEEE-rounded, so a 1 x 1 system loses no more than the plain
// version), which is also 1 / L[j][j] for the substitutions; they multiply.  In the
// substitutions lanes own right-hand-side columns (lane, lane + 32, ...),
// each substituting its own column with L read as broadcasts.  Device
// memory is read once (A, B) and written once (X).
//
// What bounds it.  Per system the work is n^3/3 + 2 n^2 r flops (~0.23
// MFLOP at n = 58, r = 25) and (n^2 + 2 n r) values moved; at B = 1024 the
// card's floor is the ~26 MB of traffic (~7.7 us at 3.35 TB/s).  A warp's
// dependent chain is n columns of a dot up to n long, then two
// substitutions of n rows each, so the kernel is latency-bound on that
// chain and relies on many warps in flight.  No wgmma or TMA (float32 at
// full precision; a 58 x 58 system has no product worth a tensor core); no
// library call.  No --use_fast_math: the 58-dof system is stiff.
#include "cholesky.cuh"

__device__ inline float xsqrt(float x) { return sqrtf(x); }
__device__ inline double xsqrt(double x) { return sqrt(x); }

#define MAX_SPB 4   // systems (warps) per block

// Values of T one system keeps in shared memory.
__host__ __device__ inline size_t sys_values(int n, int r) {
  return (size_t)n * (n + 1) + (size_t)n * r + n;
}

template <typename T>
__global__ void __launch_bounds__(32 * MAX_SPB)
spd_solve_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ x, int batch, int n, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t sys = (size_t)blockIdx.x * (blockDim.x >> 5) + w;
  if (sys >= (size_t)batch) return;          // no block barrier below
  const int lda = n + 1;
  T* A = reinterpret_cast<T*>(smem_raw) + w * sys_values(n, r);
  T* X = A + (size_t)n * lda;                // n x r, row-major
  T* rdiag = X + (size_t)n * r;              // 1 / L[j][j]
  const T* ag = a + sys * (size_t)n * n;
  const T* bg = b + sys * (size_t)n * r;
  for (int e = lane; e < n * n; e += 32) A[(e / n) * lda + e % n] = ag[e];
  for (int e = lane; e < n * r; e += 32) X[e] = bg[e];
  __syncwarp();

  // factor, left-looking by column: L[i][j] = (A[i][j] - sum_k<j L[i][k]
  // L[j][k]) * rsqrt(max(pivot, 1e-12)); the pivot row j is lane 0's.
  for (int j = 0; j < n; ++j) {
    const T* lj = A + j * lda;
    T s0 = T(0), s1 = T(0);
    const int i0 = j + lane, i1 = j + lane + 32;
    const bool has0 = i0 < n, has1 = i1 < n;
    if (has0) s0 = A[i0 * lda + j];
    if (has1) s1 = A[i1 * lda + j];
    for (int k = 0; k < j; ++k) {
      const T ljk = lj[k];
      if (has0) s0 -= A[i0 * lda + k] * ljk;
      if (has1) s1 -= A[i1 * lda + k] * ljk;
    }
    for (int i = j + lane + 64; i < n; i += 32) {   // n > j + 64 only
      T si = A[i * lda + j];
      for (int k = 0; k < j; ++k) si -= A[i * lda + k] * lj[k];
      A[i * lda + j] = si;                            // scaled below
    }
    // inv = rsqrt(max(pivot, 1e-12)), rounded as 1 / sqrt; L[j][j] =
    // pivot * inv, which is sqrt(pivot) unless the floor applies
    const T piv = __shfl_sync(0xffffffffu, s0, 0);
    const T root = xsqrt(xmax(piv, T(1e-12)));
    const T inv = T(1) / root;
    __syncwarp();
    if (has0) A[i0 * lda + j] = s0 * inv;
    if (has1) A[i1 * lda + j] = s1 * inv;
    for (int i = j + lane + 64; i < n; i += 32) A[i * lda + j] *= inv;
    if (lane == 0) rdiag[j] = piv >= T(1e-12) ? inv : root / piv;
    __syncwarp();
  }

  // substitutions: lane c solves column c (c = lane, lane + 32, ...)
  for (int c = lane; c < r; c += 32) {
    for (int j = 0; j < n; ++j) {                    // L y = b
      const T* lj = A + j * lda;
      T s = X[j * r + c];
      for (int k = 0; k < j; ++k) s -= lj[k] * X[k * r + c];
      X[j * r + c] = s * rdiag[j];
    }
    for (int j = n - 1; j >= 0; --j) {               // L^T x = y
      T s = X[j * r + c];
      for (int k = j + 1; k < n; ++k) s -= A[k * lda + j] * X[k * r + c];
      X[j * r + c] = s * rdiag[j];
    }
  }
  __syncwarp();
  T* xg = x + sys * (size_t)n * r;
  for (int e = lane; e < n * r; e += 32) xg[e] = X[e];
}

// Systems per block for (n, r): up to MAX_SPB while the block fits the
// card's per-block shared memory; 0 when one system does not fit.
template <typename T>
static int systems_per_block(int n, int r) {
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t one = sys_values(n, r) * sizeof(T);
  if (one > (size_t)max_optin) return 0;
  const size_t fit = (size_t)max_optin / one;
  return fit < MAX_SPB ? (int)fit : MAX_SPB;
}

template <typename T>
static int launch(const T* a, const T* b, T* x, int batch, int n, int r,
                  void* stream) {
  if (batch < 1 || n < 1 || r < 1) return -1;
  const int spb = systems_per_block<T>(n, r);
  if (spb == 0) return -2;
  const size_t bytes = spb * sys_values(n, r) * sizeof(T);
  const int err = opt_in_shared(spd_solve_kernel<T>, bytes);
  if (err != 0) return err;
  const int grid = (batch + spb - 1) / spb;
  spd_solve_kernel<T><<<grid, 32 * spb, bytes, (cudaStream_t)stream>>>(
      a, b, x, batch, n, r);
  return (int)cudaGetLastError();
}

extern "C" int egopose_spd_solve_f32(const void* a, const void* b, void* x,
                                     int batch, int n, int r, void* stream) {
  return launch<float>((const float*)a, (const float*)b, (float*)x, batch, n,
                       r, stream);
}

extern "C" int egopose_spd_solve_f64(const void* a, const void* b, void* x,
                                     int batch, int n, int r, void* stream) {
  return launch<double>((const double*)a, (const double*)b, (double*)x, batch,
                        n, r, stream);
}

// Resources of the kernel for (n, r) and dtype (0 float, 1 double): out[0]
// blocks per SM, out[1] registers per thread, out[2] dynamic shared bytes
// per block, out[3] local (spill) bytes per thread, out[4] systems per
// block.
template <typename T>
static int occupancy(int n, int r, int* out) {
  if (n < 1 || r < 1) return -1;
  const int spb = systems_per_block<T>(n, r);
  if (spb == 0) return -2;
  const size_t bytes = spb * sys_values(n, r) * sizeof(T);
  int err = opt_in_shared(spd_solve_kernel<T>, bytes);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, spd_solve_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], spd_solve_kernel<T>,
                                                    32 * spb, bytes);
  out[1] = attr.numRegs;
  out[2] = (int)bytes;
  out[3] = (int)attr.localSizeBytes;
  out[4] = spb;
  return (int)e;
}

extern "C" int egopose_spd_solve_occupancy(int n, int r, int f64, int* out) {
  return f64 ? occupancy<double>(n, r, out) : occupancy<float>(n, r, out);
}
