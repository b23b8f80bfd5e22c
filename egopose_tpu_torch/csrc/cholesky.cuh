// One-warp dense Cholesky factor and single-column triangular solves in
// shared memory, shared by the batched SPD solve (spd_solve.cu, K2), the
// fused contact solve and the fused stable-PD substep (fused_contact.cu,
// K3 and K4) and the dense branch of the control step (substep.cu, K1).
//
// Every function here is called by all 32 lanes of one warp and works on
// one system in shared memory; lanes synchronise with __syncwarp and
// shuffles only, so several systems share a block without a block barrier.
// The factor is the counterpart of egopose_tpu/physics/linalg_pallas.py::
// _factor_blocked (every pivot floored at 1e-12 before its reciprocal
// square root): the arithmetic, not the TPU's 128-lane layout or its
// 8-column panels.  L sits in an n x (n + 1) square (odd row stride, so
// the 32 rows a warp reads at once in one column fall in 32 distinct
// banks), in its lower triangle or, transposed, in its upper one (RowMajor,
// UpperShifted), so that two factors share a square (K4, K1's dense
// branch).  A caller may run work beside the factor that needs row j of L
// when the factor forms column j (a ``Rider``: the forward substitutions
// of K1-dense, K3 and K4, SubstRider below); K2 runs none.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

__device__ inline float xsqrt(float x) { return sqrtf(x); }
__device__ inline double xsqrt(double x) { return sqrt(x); }
__device__ inline float xmax(float a, float b) { return fmaxf(a, b); }
__device__ inline double xmax(double a, double b) { return fmax(a, b); }
__device__ inline float xmin(float a, float b) { return fminf(a, b); }
__device__ inline double xmin(double a, double b) { return fmin(a, b); }
__device__ inline float xabs(float x) { return fabsf(x); }
__device__ inline double xabs(double x) { return fabs(x); }

#define FULL_MASK 0xffffffffu

// What warp_cholesky runs beside the factor: nothing (K2), or a forward
// substitution that needs row j of L when the factor forms column j (K1's
// dense branch, K3, K4: SubstRider).  begin(j) precedes column j's dot,
// step(k, L[j][k]) runs for each k < j inside it, in order, finish(j,
// 1 / L[j][j]) follows the column; the rider only ever touches its own
// lane's data.
struct NoRider {
  __device__ void begin(int) {}
  template <typename T> __device__ void step(int, T) {}
  template <typename T> __device__ void finish(int, T) {}
};

// Where L[i][k] (k <= i) sits in an n x (n + 1) square of row stride lda:
// row-major in the lower triangle (RowMajor, the default), or transposed
// into the upper triangle one column to the right (UpperShifted), so that
// two factors of one size share one square without touching each other's
// entries (K4).  Either way a column of L read by the 32 lanes at once, or
// a row read as a broadcast, falls in distinct banks when lda is odd.
struct RowMajor {
  __device__ static int at(int i, int k, int lda) { return i * lda + k; }
};
struct UpperShifted {
  __device__ static int at(int i, int k, int lda) { return k * lda + i + 1; }
};

// A (n x n, row stride lda) = L L^T in place, left-looking by column: lanes
// own rows (lane, lane + 32, ...) and form L[i][j] from a dot over k < j
// with L[j][k] read as a broadcast; the pivot row j is lane 0's.  Each
// column takes one reciprocal square root of max(pivot, 1e-12), as an
// IEEE-rounded 1 / sqrt (so a 1 x 1 system loses no more than the plain
// version), which is also 1 / L[j][j] unless the floor applies; rdiag[j]
// receives 1 / L[j][j] in either case.  Only the entries of the lower
// triangle (in the layout ``Lay``) are read or written.  The dot keeps one
// accumulator per row: four partial sums with their loads issued ahead
// timed slower on the card for K1's dense branch and K2-K4 alike
// (PERF.md).  Ends with __syncwarp.
template <typename T, typename Rider = NoRider, typename Lay = RowMajor>
__device__ void warp_cholesky(T* A, int lda, T* rdiag, int n, int lane,
                              Rider rider = Rider(), Lay = Lay()) {
  for (int j = 0; j < n; ++j) {
    T s0 = T(0), s1 = T(0);
    const int i0 = j + lane, i1 = j + lane + 32;
    const bool has0 = i0 < n, has1 = i1 < n;
    if (has0) s0 = A[Lay::at(i0, j, lda)];
    if (has1) s1 = A[Lay::at(i1, j, lda)];
    rider.begin(j);
    for (int k = 0; k < j; ++k) {
      const T ljk = A[Lay::at(j, k, lda)];
      if (has0) s0 -= A[Lay::at(i0, k, lda)] * ljk;
      if (has1) s1 -= A[Lay::at(i1, k, lda)] * ljk;
      rider.step(k, ljk);
    }
    for (int i = j + lane + 64; i < n; i += 32) {   // n > j + 64 only
      T si = A[Lay::at(i, j, lda)];
      for (int k = 0; k < j; ++k)
        si -= A[Lay::at(i, k, lda)] * A[Lay::at(j, k, lda)];
      A[Lay::at(i, j, lda)] = si;                     // scaled below
    }
    // inv = rsqrt(max(pivot, 1e-12)), rounded as 1 / sqrt; L[j][j] =
    // pivot * inv, which is sqrt(pivot) unless the floor applies
    const T piv = __shfl_sync(FULL_MASK, s0, 0);
    const T root = xsqrt(xmax(piv, T(1e-12)));
    const T inv = T(1) / root;
    __syncwarp();
    if (has0) A[Lay::at(i0, j, lda)] = s0 * inv;
    if (has1) A[Lay::at(i1, j, lda)] = s1 * inv;
    for (int i = j + lane + 64; i < n; i += 32) A[Lay::at(i, j, lda)] *= inv;
    if (lane == 0) rdiag[j] = piv >= T(1e-12) ? inv : root / piv;
    rider.finish(j, piv >= T(1e-12) ? inv : root / piv);
    __syncwarp();
  }
}

// The forward substitution Z <- L^-1 Z of up to two columns per lane (col,
// col + 32, for the columns [c0, c1) of Z, row stride ldz) run beside
// warp_cholesky: row j of Z needs row j of L, which the factor reads as
// broadcasts while it forms column j, so each step(k, L[j][k]) adds its
// products and finish(j, 1 / L[j][j]) completes z_j.  With ``jq``, also
// jq[col - jq0] = sum_j Z[j][col] vq[j] of each column col >= jq0 as
// loaded (J v from the J^T columns: K3 and K4 keep dt qfrc in column 0,
// jq0 = 1; K1's dense branch has J^T alone, jq0 = 0).
template <typename T>
struct SubstRider {
  T* Z;
  int ldz, ca, cb, n, jq0;
  bool ha, hb;
  const T* vq;
  T* jq;
  T sa, sb, qa, qb;

  __device__ SubstRider(T* z, int ldz_, int c0, int c1, int n_, int lane,
                        const T* vq_, T* jq_, int jq0_ = 1)
      : Z(z), ldz(ldz_), ca(c0 + lane), cb(c0 + lane + 32), n(n_),
        jq0(jq0_), ha(c0 + lane < c1), hb(c0 + lane + 32 < c1), vq(vq_),
        jq(jq_), sa(T(0)), sb(T(0)), qa(T(0)), qb(T(0)) {}

  __device__ void begin(int j) {
    if (ha) sa = Z[j * ldz + ca];
    if (hb) sb = Z[j * ldz + cb];
    if (jq != nullptr) {
      qa += sa * vq[j];
      qb += sb * vq[j];
    }
  }
  __device__ void step(int k, T ljk) {
    if (ha) sa -= ljk * Z[k * ldz + ca];
    if (hb) sb -= ljk * Z[k * ldz + cb];
  }
  __device__ void finish(int j, T rdj) {
    if (ha) Z[j * ldz + ca] = sa * rdj;
    if (hb) Z[j * ldz + cb] = sb * rdj;
    if (jq != nullptr && j == n - 1) {
      if (ha && ca >= jq0) jq[ca - jq0] = qa;
      if (hb && cb >= jq0) jq[cb - jq0] = qb;
    }
  }
};

// y <- L^-1 y for one column y (element i at y[i * incy]), by blocks of
// 32 rows: each lane holds its row of the block in a register, x_j is
// broadcast from the owner lane by a shuffle and the rows below j in the
// block subtract L[i][j] x_j (column j of L: odd row stride, no bank
// conflict); then the rows below the block subtract their dot with the
// block's x, lanes over rows.  Ends with __syncwarp.
template <typename T, typename Lay = RowMajor>
__device__ void warp_lsolve_vec(const T* A, int lda, const T* rdiag, T* y,
                                int incy, int n, int lane, Lay = Lay()) {
  for (int b0 = 0; b0 < n; b0 += 32) {
    const int i = b0 + lane, b1 = min(n, b0 + 32);
    T yi = i < n ? y[i * incy] : T(0);
    for (int j = b0; j < b1; ++j) {
      const T lij = i > j && i < n ? A[Lay::at(i, j, lda)] : T(0);
      const T xj = __shfl_sync(FULL_MASK, yi * rdiag[j], j - b0);
      if (i == j) yi = xj;
      else if (i > j) yi -= lij * xj;
    }
    if (i < n) y[i * incy] = yi;
    __syncwarp();
    for (int r = b1 + lane; r < n; r += 32) {
      T a0 = T(0), a1 = T(0);
      int j = b0;
      for (; j + 1 < b1; j += 2) {
        a0 += A[Lay::at(r, j, lda)] * y[j * incy];
        a1 += A[Lay::at(r, j + 1, lda)] * y[(j + 1) * incy];
      }
      if (j < b1) a0 += A[Lay::at(r, j, lda)] * y[j * incy];
      y[r * incy] -= a0 + a1;
    }
    __syncwarp();
  }
}

// y <- L^-T y for one column, by blocks of 32 rows from the last: as
// warp_lsolve_vec, with row j of L (contiguous: no bank conflict) in place
// of its column.  Ends with __syncwarp.
template <typename T, typename Lay = RowMajor>
__device__ void warp_ltsolve_vec(const T* A, int lda, const T* rdiag, T* y,
                                 int incy, int n, int lane, Lay = Lay()) {
  for (int b0 = (n - 1) & ~31; b0 >= 0; b0 -= 32) {
    const int i = b0 + lane, b1 = min(n, b0 + 32);
    T yi = i < n ? y[i * incy] : T(0);
    for (int j = b1 - 1; j >= b0; --j) {
      const T lji = i < j ? A[Lay::at(j, i, lda)] : T(0);
      const T xj = __shfl_sync(FULL_MASK, yi * rdiag[j], j - b0);
      if (i == j) yi = xj;
      else if (i < j) yi -= lji * xj;
    }
    if (i < n) y[i * incy] = yi;
    __syncwarp();
    for (int r = lane; r < b0; r += 32) {
      T a0 = T(0), a1 = T(0);
      int j = b0;
      for (; j + 1 < b1; j += 2) {
        a0 += A[Lay::at(j, r, lda)] * y[j * incy];
        a1 += A[Lay::at(j + 1, r, lda)] * y[(j + 1) * incy];
      }
      if (j < b1) a0 += A[Lay::at(j, r, lda)] * y[j * incy];
      y[r * incy] -= a0 + a1;
    }
    __syncwarp();
  }
}

// Systems per block: up to max_spb while the block fits the card's
// per-block shared memory (``one``: bytes of one system); 0 when one
// system does not fit.
static int systems_per_block(size_t one, int max_spb) {
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (one > (size_t)max_optin) return 0;
  const size_t fit = (size_t)max_optin / one;
  return fit < (size_t)max_spb ? (int)fit : max_spb;
}

// Opt a kernel in to ``bytes`` of dynamic shared memory.  Returns 0, -2
// when the card's per-block limit is smaller, or a CUDA error code.
template <typename K>
static int opt_in_shared(K kernel, size_t bytes) {
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)max_optin) return -2;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Resources of ``kernel`` launched with ``spb`` systems of ``threads_per``
// threads and ``one`` shared bytes each: out[0] blocks per SM, out[1]
// registers per thread, out[2] dynamic shared bytes per block, out[3]
// local (spill) bytes per thread, out[4] systems per block.
template <typename K>
static int kernel_occupancy(K kernel, int spb, int threads_per, size_t one,
                            int* out) {
  if (spb == 0) return -2;
  const size_t bytes = spb * one;
  int err = opt_in_shared(kernel, bytes);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                    threads_per * spb, bytes);
  out[1] = attr.numRegs;
  out[2] = (int)bytes;
  out[3] = (int)attr.localSizeBytes;
  out[4] = spb;
  return (int)e;
}
