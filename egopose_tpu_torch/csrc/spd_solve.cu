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
// B = 1024 runs in one wave on the H100's 132 SMs.  The factor
// (cholesky.cuh's warp_cholesky, shared with K3 and K4) is left-looking by
// column: lanes own rows (lane, lane + 32, ...) and form L[i][j] from a
// dot over k < j with L[j][k] read as a broadcast; the odd row stride puts
// the 32 rows a warp reads at once in 32 distinct banks.
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

  warp_cholesky(A, lda, rdiag, n, lane);   // cholesky.cuh

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

template <typename T>
static int launch(const T* a, const T* b, T* x, int batch, int n, int r,
                  void* stream) {
  if (batch < 1 || n < 1 || r < 1) return -1;
  const int spb = systems_per_block(sys_values(n, r) * sizeof(T), MAX_SPB);
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
  const size_t one = sys_values(n, r) * sizeof(T);
  return kernel_occupancy(spd_solve_kernel<T>,
                          systems_per_block(one, MAX_SPB), 32, one, out);
}

extern "C" int egopose_spd_solve_occupancy(int n, int r, int f64, int* out) {
  return f64 ? occupancy<double>(n, r, out) : occupancy<float>(n, r, out);
}
