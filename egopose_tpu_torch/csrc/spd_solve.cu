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
// 15 launches per torque-mode control step (engine.torque_control_step).
//
// Design.  One thread block per system, 256 threads.  A (n x n) and X
// (n x r) live in dynamic shared memory: at n = 58, r = 25 that is 19.3 KB
// in float and 38.6 KB in double; above 48 KB the launch opts in, up to the
// card's per-block limit (227 KB on an H100), and refuses beyond it.  The
// factor and the substitutions are cholesky.cuh's (shared with K3 and K4 in
// fused_contact.cu): one __syncthreads per stage, n stages for the factor
// and 2n for the solves.  Device memory is read once (A, B) and written
// once (X).
//
// What bounds it.  Per system the work is n^3/3 + 2 n^2 r flops (~0.23
// MFLOP at n = 58, r = 25) and (n^2 + 2 n r) values moved; at B = 1024 the
// card's floor is the ~26 MB of traffic (~7.7 us at 3.35 TB/s).  The kernel
// is a simple one: its stages are short, so a block is latency-bound on
// that chain and the card needs many blocks in flight, which the small
// shared footprint allows (several blocks per SM).  No wgmma or TMA; no
// library call.  No --use_fast_math: the 58-dof system is stiff.
#include "cholesky.cuh"

#define NT 256

template <typename T>
__global__ void __launch_bounds__(NT)
spd_solve_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ x, int n, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);   // n*n, row-major
  T* X = A + n * n;                         // n*r, row-major
  T* dinv = X + n * r;                      // n pivot scales
  const int tid = threadIdx.x;
  const size_t sys = blockIdx.x;
  const T* ag = a + sys * (size_t)n * n;
  const T* bg = b + sys * (size_t)n * r;
  for (int e = tid; e < n * n; e += NT) A[e] = ag[e];
  for (int e = tid; e < n * r; e += NT) X[e] = bg[e];
  __syncthreads();
  block_cholesky(A, dinv, n);
  block_cho_solve(A, X, n, r);
  T* xg = x + sys * (size_t)n * r;
  for (int e = tid; e < n * r; e += NT) xg[e] = X[e];
}

template <typename T>
static int launch(const T* a, const T* b, T* x, int batch, int n, int r,
                  void* stream) {
  if (batch < 1 || n < 1 || r < 1) return -1;
  const size_t bytes = ((size_t)n * n + (size_t)n * r + n) * sizeof(T);
  const int err = opt_in_shared(spd_solve_kernel<T>, bytes);
  if (err != 0) return err;
  spd_solve_kernel<T><<<batch, NT, bytes, (cudaStream_t)stream>>>(a, b, x, n, r);
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
