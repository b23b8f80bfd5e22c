// Fused dynamics + contact solve (K3) and fused stable-PD substep (K4) for
// Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel egopose_tpu/physics/linalg_pallas.py::
// _fused_contact_kernel (launched by _fused_contact_tpu through
// make_fused_contact_solve).  For each system it factors A = L L^T, solves
// A X = [dt qfrc | J^T] (column 0 is dt qacc, the others the Delassus
// columns W = A^-1 J^T), forms v_pred = qvel + dt qacc, the Delassus
// operator J W and the residual J v_pred - target, runs the projected-Jacobi
// sweep (_contact_sweep / _sweep_lam) and returns v_new = v_pred + W lam.
//
// K4 replaces _pd_fused_kernel (launched by _pd_fused_tpu through
// make_pd_fused_step): one stable-PD substep's solve chain.  It factors
// A_pd = M + dt diag(kdd[:,0]) and solves it for the PD acceleration, forms
// the clamped torque clip(-jkp e - jkd (qvel + dt qacc), +-tlim) and
// qfrc = qfb + torque gear, factors A_dyn = M + dt diag(kdd[:,1]), and then
// runs K3's solve and sweep on it.
//
// Contact rows are in block order: k tangent-x rows, k tangent-y rows, k
// normal rows (friction box |lam_t| <= mu max(lam_n, 0)), then c - 3k
// frictionless pair rows (lam >= 0).  The sweep scales each row by the
// row-sum (Gershgorin) preconditioner relax / (sum_j |D_ij| + 1e-9).
//
// Design.  One thread block per system, 256 threads; the factor and the
// substitutions are cholesky.cuh's (K2's).  A, X = [dt qfrc | J^T]
// (n x (1+c)), J (c x n), the c x c Delassus matrix and lam sit in dynamic
// shared memory; K4 also keeps M for its second factor.  On the humanoid
// (n = 58, c = 24, k = 6) K3 takes 28.3 KB in float and 56.7 KB in double,
// K4 42.0 KB and 84.0 KB; at the JAX tests' c = 48, k = 16 double K4 takes
// 121.2 KB.  Above 48 KB the launch opts in, up to the card's per-block limit
// (227 KB on an H100), and refuses beyond it (error -2): the row count c is
// bounded by shared memory only, since every stage loops over its rows.
// The sweep is Jacobi over all rows at once: one thread per row forms its
// residual from the previous lam, a barrier, the projection, a barrier.
// Device memory is read once (every input) and written once (v_new).
//
// What bounds it.  Per system the work is n^3/3 (K4: twice) + 2 n^2 (1+c)
// flops for the factor and substitutions, 2 c^2 n for the Delassus matrix
// and 2 c^2 iters for the sweep: ~0.28 MFLOP for K3 and ~0.35 for K4 on the
// humanoid, against ~16-20 KB moved.  At B = 1024 the card's floor is the
// bytes (~5-6 us); the kernel is latency-bound on its chain of ~3n + 2 iters
// barrier stages (K4: ~5n), as K2 is, and relies on several blocks per SM.
// No wgmma or TMA; no library call.  No --use_fast_math: the 58-dof system
// is stiff.
#include "cholesky.cuh"

#define NT 256

// From X = [dt qacc | W] (n x (1+c), solved, in shared memory): the
// Delassus matrix D = J W, the residual J v_pred - target, the sweep, and
// v_new = v_pred + W lam written to ``out`` (one system's n values).
template <typename T>
__device__ void contact_sweep(const T* X, const T* J, const T* vq,
                              const T* tgt, const T* mu, T* D, T* vp, T* gid,
                              T* bh, T* lam, T* lnew, int n, int c, int k,
                              int iters, T relax, T* __restrict__ out) {
  const int tid = threadIdx.x, nt = blockDim.x, ldx = 1 + c;
  for (int i = tid; i < n; i += nt) vp[i] = vq[i] + X[i * ldx];
  for (int e = tid; e < c * c; e += nt) {
    const int a = e / c, b = e % c;
    T acc = T(0);
    for (int d = 0; d < n; ++d) acc += J[a * n + d] * X[d * ldx + 1 + b];
    D[e] = acc;
  }
  __syncthreads();
  for (int a = tid; a < c; a += nt) {
    T acc = T(0), rowsum = T(0);
    for (int d = 0; d < n; ++d) acc += J[a * n + d] * vp[d];
    for (int b = 0; b < c; ++b) rowsum += xabs(D[a * c + b]);
    bh[a] = acc - tgt[a];
    gid[a] = relax / (rowsum + T(1e-9));
    lam[a] = T(0);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int r = tid; r < c; r += nt) {
      T g = T(0);
      for (int j = 0; j < c; ++j) g += D[r * c + j] * lam[j];
      lnew[r] = lam[r] - (g + bh[r]) * gid[r];
    }
    __syncthreads();
    for (int r = tid; r < c; r += nt) {
      const T x = lnew[r];
      if (r < 2 * k) {
        const T lim = mu[r % k] * xmax(lnew[2 * k + r % k], T(0));
        lam[r] = xmin(xmax(x, -lim), lim);
      } else {
        lam[r] = xmax(x, T(0));
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += nt) {
    T acc = T(0);
    for (int r = 0; r < c; ++r) acc += X[i * ldx + 1 + r] * lam[r];
    out[i] = vp[i] + acc;
  }
}

// Shared-memory footprint in elements of T (pd: K4's extra M and PD column).
__host__ __device__ inline size_t fused_elems(int n, int c, int k, bool pd) {
  return (size_t)n * n * (pd ? 2 : 1) + (size_t)n * (1 + c) + (size_t)c * n
      + (size_t)c * c + (size_t)n * (pd ? 4 : 3) + 5 * (size_t)c + k;
}

template <typename T>
__global__ void __launch_bounds__(NT)
fused_contact_kernel(const T* __restrict__ a, const T* __restrict__ qfrc,
                     const T* __restrict__ qvel, const T* __restrict__ jf,
                     const T* __restrict__ target, const T* __restrict__ mu,
                     T* __restrict__ out, int n, int c, int k, int iters,
                     T dt, T relax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = 1 + c;
  T* A = reinterpret_cast<T*>(smem_raw);  // n*n
  T* X = A + n * n;                        // n*(1+c)
  T* J = X + n * ldx;                      // c*n
  T* D = J + c * n;                        // c*c
  T* dinv = D + c * c;                     // n
  T* vq = dinv + n;                        // n
  T* vp = vq + n;                          // n
  T* tg = vp + n;                          // c
  T* gid = tg + c;                         // c
  T* bh = gid + c;                         // c
  T* lam = bh + c;                         // c
  T* lnew = lam + c;                       // c
  T* mus = lnew + c;                       // k
  const int tid = threadIdx.x;
  const size_t sys = blockIdx.x;
  for (int e = tid; e < n * n; e += NT) A[e] = a[sys * n * n + e];
  for (int e = tid; e < c * n; e += NT) J[e] = jf[sys * c * n + e];
  for (int i = tid; i < n; i += NT) vq[i] = qvel[sys * n + i];
  for (int r = tid; r < c; r += NT) tg[r] = target[sys * c + r];
  for (int r = tid; r < k; r += NT) mus[r] = mu[sys * k + r];
  __syncthreads();
  for (int e = tid; e < n * ldx; e += NT) {
    const int i = e / ldx, col = e % ldx;
    X[e] = col == 0 ? dt * qfrc[sys * n + i] : J[(col - 1) * n + i];
  }
  __syncthreads();
  block_cholesky(A, dinv, n);
  block_cho_solve(A, X, n, ldx);
  contact_sweep(X, J, vq, tg, mus, D, vp, gid, bh, lam, lnew, n, c, k, iters,
                relax, out + sys * n);
}

template <typename T>
__global__ void __launch_bounds__(NT)
pd_fused_kernel(const T* __restrict__ mmat, const T* __restrict__ kdd,
                const T* __restrict__ rhspd, const T* __restrict__ e,
                const T* __restrict__ jkp, const T* __restrict__ jkd,
                const T* __restrict__ tlim, const T* __restrict__ gear,
                const T* __restrict__ qfb, const T* __restrict__ qvel,
                const T* __restrict__ jf, const T* __restrict__ target,
                const T* __restrict__ mu, T* __restrict__ out, int n, int c,
                int k, int iters, T dt, T relax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = 1 + c;
  T* M = reinterpret_cast<T*>(smem_raw);  // n*n
  T* A = M + n * n;                        // n*n
  T* X = A + n * n;                        // n*(1+c)
  T* J = X + n * ldx;                      // c*n
  T* D = J + c * n;                        // c*c
  T* dinv = D + c * c;                     // n
  T* vq = dinv + n;                        // n
  T* vp = vq + n;                          // n
  T* xpd = vp + n;                         // n
  T* tg = xpd + n;                         // c
  T* gid = tg + c;                         // c
  T* bh = gid + c;                         // c
  T* lam = bh + c;                         // c
  T* lnew = lam + c;                       // c
  T* mus = lnew + c;                       // k
  const int tid = threadIdx.x;
  const size_t sys = blockIdx.x;
  const T* kd = kdd + sys * n * 2;         // (n,2): [jkd_full, dof_damping]
  // ---- stable-PD solve: (M + dt diag(kdd[:,0])) qacc = rhspd ----
  for (int x = tid; x < n * n; x += NT) {
    const int i = x / n, j = x % n;
    const T m = mmat[sys * n * n + x];
    M[x] = m;
    A[x] = i == j ? m + dt * kd[2 * i] : m;
  }
  for (int x = tid; x < c * n; x += NT) J[x] = jf[sys * c * n + x];
  for (int i = tid; i < n; i += NT) {
    vq[i] = qvel[sys * n + i];
    xpd[i] = rhspd[sys * n + i];
  }
  for (int r = tid; r < c; r += NT) tg[r] = target[sys * c + r];
  for (int r = tid; r < k; r += NT) mus[r] = mu[sys * k + r];
  __syncthreads();
  block_cholesky(A, dinv, n);
  block_cho_solve(A, xpd, n, 1);
  // ---- clamped torque -> qfrc (column 0, times dt); dynamics system ----
  for (int i = tid; i < n; i += NT) {
    const size_t g = sys * n + i;
    const T lim = tlim[g];
    T tq = -jkp[g] * e[g] - jkd[g] * (vq[i] + dt * xpd[i]);
    tq = xmin(xmax(tq, -lim), lim);
    X[i * ldx] = (qfb[g] + tq * gear[g]) * dt;
  }
  for (int x = tid; x < n * n; x += NT) {
    const int i = x / n, j = x % n;
    A[x] = i == j ? M[x] + dt * kd[2 * i + 1] : M[x];
  }
  for (int x = tid; x < n * c; x += NT) {
    const int i = x / c, r = x % c;
    X[i * ldx + 1 + r] = J[r * n + i];
  }
  __syncthreads();
  block_cholesky(A, dinv, n);
  block_cho_solve(A, X, n, ldx);
  contact_sweep(X, J, vq, tg, mus, D, vp, gid, bh, lam, lnew, n, c, k, iters,
                relax, out + sys * n);
}

static bool bad_dims(int batch, int n, int c, int k, int iters) {
  return batch < 1 || n < 1 || c < 1 || k < 0 || 3 * k > c || iters < 0;
}

template <typename T>
static int launch_fused(const T* a, const T* qfrc, const T* qvel, const T* jf,
                        const T* target, const T* mu, T* out, int batch, int n,
                        int c, int k, int iters, double dt, double relax,
                        void* stream) {
  if (bad_dims(batch, n, c, k, iters)) return -1;
  const size_t bytes = fused_elems(n, c, k, false) * sizeof(T);
  const int err = opt_in_shared(fused_contact_kernel<T>, bytes);
  if (err != 0) return err;
  fused_contact_kernel<T><<<batch, NT, bytes, (cudaStream_t)stream>>>(
      a, qfrc, qvel, jf, target, mu, out, n, c, k, iters, T(dt), T(relax));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_pd(const T* mmat, const T* kdd, const T* rhspd, const T* e,
                     const T* jkp, const T* jkd, const T* tlim, const T* gear,
                     const T* qfb, const T* qvel, const T* jf, const T* target,
                     const T* mu, T* out, int batch, int n, int c, int k,
                     int iters, double dt, double relax, void* stream) {
  if (bad_dims(batch, n, c, k, iters)) return -1;
  const size_t bytes = fused_elems(n, c, k, true) * sizeof(T);
  const int err = opt_in_shared(pd_fused_kernel<T>, bytes);
  if (err != 0) return err;
  pd_fused_kernel<T><<<batch, NT, bytes, (cudaStream_t)stream>>>(
      mmat, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, qvel, jf, target, mu,
      out, n, c, k, iters, T(dt), T(relax));
  return (int)cudaGetLastError();
}

#define FUSED_ENTRY(name, T)                                                  \
  extern "C" int name(const void* a, const void* qfrc, const void* qvel,      \
                      const void* jf, const void* target, const void* mu,     \
                      void* out, int batch, int n, int c, int k, int iters,   \
                      double dt, double relax, void* stream) {                \
    return launch_fused<T>((const T*)a, (const T*)qfrc, (const T*)qvel,       \
                           (const T*)jf, (const T*)target, (const T*)mu,      \
                           (T*)out, batch, n, c, k, iters, dt, relax,         \
                           stream);                                           \
  }

#define PD_ENTRY(name, T)                                                     \
  extern "C" int name(const void* mmat, const void* kdd, const void* rhspd,   \
                      const void* e, const void* jkp, const void* jkd,        \
                      const void* tlim, const void* gear, const void* qfb,    \
                      const void* qvel, const void* jf, const void* target,   \
                      const void* mu, void* out, int batch, int n, int c,     \
                      int k, int iters, double dt, double relax,              \
                      void* stream) {                                         \
    return launch_pd<T>((const T*)mmat, (const T*)kdd, (const T*)rhspd,       \
                        (const T*)e, (const T*)jkp, (const T*)jkd,            \
                        (const T*)tlim, (const T*)gear, (const T*)qfb,        \
                        (const T*)qvel, (const T*)jf, (const T*)target,       \
                        (const T*)mu, (T*)out, batch, n, c, k, iters, dt,     \
                        relax, stream);                                       \
  }

FUSED_ENTRY(egopose_fused_contact_f32, float)
FUSED_ENTRY(egopose_fused_contact_f64, double)
PD_ENTRY(egopose_pd_fused_f32, float)
PD_ENTRY(egopose_pd_fused_f64, double)
