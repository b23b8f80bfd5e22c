// Fused dynamics + contact solve (K3) and fused stable-PD substep (K4) for
// Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel egopose_tpu/physics/linalg_pallas.py::
// _fused_contact_kernel (launched by _fused_contact_tpu through
// make_fused_contact_solve): for each system, with A = L L^T (every pivot
// floored at 1e-12), W = A^-1 J^T and v_pred = qvel + dt A^-1 qfrc, the
// projected-Jacobi sweep (_contact_sweep / _sweep_lam) on the Delassus
// matrix J W gives lam, and v_new = v_pred + W lam.
//
// K4 replaces _pd_fused_kernel (launched by _pd_fused_tpu through
// make_pd_fused_step): one stable-PD substep's solve chain.  It solves
// (M + dt diag(kdd[:,0])) qacc = rhspd, forms the clamped torque
// clip(-jkp e - jkd (qvel + dt qacc), +-tlim) and qfrc = qfb + torque gear,
// and then runs K3 on A_dyn = M + dt diag(kdd[:,1]).
//
// Contact rows are in block order: k tangent-x rows, k tangent-y rows, k
// normal rows (friction box |lam_t| <= mu max(lam_n, 0)), then c - 3k
// frictionless pair rows (lam >= 0).  The sweep scales each row by the
// row-sum (Gershgorin) preconditioner relax / (sum_j |D_ij| + 1e-9).
//
// The contact solve runs forward only, the Cholesky form of what the JAX
// package's K1 does with its LDL^T (_delassus_sym, _contact_sweep_sym):
//   Z = L^-1 [dt qfrc | J^T]   forward substitution, lanes over columns,
//                              run beside the factor (cholesky.cuh's
//                              SubstRider): row j
//                              of Z needs row j of L, which the factor
//                              reads as it forms column j
//   D = Z_c^T Z_c              = J A^-1 J^T, lower triangle, mirrored
//   bhat = J qvel + Z_c^T z0 - target
//                              J qvel read off the J^T columns as the
//                              substitution passes them, so v_pred is
//                              never formed
//   lam = sweep(D, bhat)       lanes over rows
//   v_new = qvel + L^-T (z0 + Z_c lam)
//                              one single-column back substitution
// W and the backward substitution of the c columns are never formed.
//
// Design.  One warp per system (K4: two) and no block barrier: a warp
// synchronises with __syncwarp and shuffles only, and a block holds up to
// four systems, so a block that is only partly filled returns before any
// synchronisation; a small batch takes one system per block, up to one
// per SM.  The factor is cholesky.cuh's one-warp left-looking factor,
// shared with K2.  Per system, L (row stride n + 1), Z (row stride 1 + c
// rounded up to odd), D (c x c, symmetric, read by columns) and the row
// vectors live in dynamic shared memory, filled by cp.async; the odd
// strides keep the lanes' reads of a column of L or Z in distinct banks.
// On the humanoid (n = 58, c = 24, k = 6) K3 takes 22.7 KB in float and
// 64 registers, four systems per block and two blocks (eight warps) per
// SM: B = 1024 runs in 0.97 waves on the H100's 132 SMs.
//
// K4 runs its two factors side by side: the PD system and the dynamics
// system depend only on M and kdd, and only z0 depends on the torque.  Two
// warps per system: warp 0 factors A_pd with the PD column riding on the
// factor, back-substitutes it and forms dt qfrc; warp 1 factors A_dyn with
// the J^T columns riding on it and forms D.  The two factors share one
// square: A_dyn's L in the lower triangle, A_pd's transposed into the
// upper one (cholesky.cuh's UpperShifted), so a system takes 23.1 KB in
// float, four per block, eight per SM, 0.97 waves at B = 1024.  The warps
// join on a named barrier of 64 threads (bar.arrive by warp 0, which then
// exits; bar.sync by warp 1; id 1 + the system's slot in the block), and
// warp 1 finishes: z0 = L^-1 dt qfrc, the sweep, the back substitution.
// One warp running both factors in turn read 1.13x slower at B = 1024 and
// 1.5x at B = 64, the batches K4's paths launch (PERF.md).
//
// What bounds it.  Per system the work is n^3/3 (K4: twice) + n^2 (1 + c)
// flops for the factor and the forward substitution, c^2 n for D and
// 2 c^2 iters for the sweep: ~0.16 MFLOP for K3 on the humanoid, against
// ~16-20 KB moved.  At B = 1024 the card's floor is the bytes (~5-6 us);
// the kernel is latency-bound on one warp's chain and relies on several
// warps per SM.  Its stage clocks (chip_smoke.py phase k34_stages) put
// two thirds of that chain in the factor with the substitution beside it,
// then the loads, D, the sweep and the back substitution.  No wgmma or
// TMA (a 58 x 58 system has no product worth a tensor core, and float32
// stays at full precision); no library call.  No --use_fast_math: the
// 58-dof system is stiff.
#include "cholesky.cuh"

#define MAX_SPB 4     // K3: systems (warps) per block
#define MAX_PAIRS 4   // K4: systems (pairs of warps) per block; barrier ids
                      // 1..MAX_PAIRS (at most 15)

// Stage clocks.  Built with -DEGOPOSE_STAGE_CLOCKS, lane 0 of every warp
// writes clock64() at the start and at the end of each stage it runs to
// clocks[warp * N_STAGES + stage] (warp: the system for K3, 2 x system +
// 0 (PD) or 1 (dynamics) for K4), set by egopose_fused_clocks; stages
// follow each other, so a stage's cycles are its stamp minus the warp's
// previous one (physics/linalg.py::FUSED_STAGES).  The main library has
// no clock code.
enum { ST_START, ST_LOAD, ST_FACTOR, ST_GRAM, ST_WAIT, ST_Z0, ST_PREP,
       ST_SWEEP, ST_VELOCITY, ST_PD_FACTOR, ST_PD_BACK, ST_TORQUE,
       N_STAGES };
#ifdef EGOPOSE_STAGE_CLOCKS
__device__ long long* stage_clocks;
#define STAMP(stage)                                                       \
  do {                                                                     \
    __syncwarp();                                                          \
    if ((threadIdx.x & 31) == 0)                                           \
      stage_clocks[((size_t)blockIdx.x * (blockDim.x >> 5)                 \
                    + (threadIdx.x >> 5)) * N_STAGES + (stage)] = clock64(); \
  } while (0)
extern "C" int egopose_fused_clocks(void* clocks) {
  return (int)cudaMemcpyToSymbol(stage_clocks, &clocks, sizeof(clocks));
}
#else
#define STAMP(stage)
#endif

// One system's shared arrays: the n x (n + 1) square of L (K4's two
// factors share it, one in each triangle), the reciprocal diagonal(s) (rd;
// K4's PD factor rd2), Z, D, qvel, K4's PD column (xpd), the four row
// vectors (bhat, preconditioner, lam, the sweep's next lam) and mu.  P is
// T* (the arrays from a system's base) or size_t (their offsets in values
// of T from 0): the launcher sizes a system as Sys<size_t>(0, ...).end.
__host__ __device__ inline int z_stride(int c) { return (c + 1) | 1; }

template <typename P>
struct Sys {
  P L, rd, rd2, Z, D, vq, xpd, bh, gid, lam, lnew, mu, end;
  int n, c, k, lda, ldz;

  __host__ __device__ Sys(P p, int n_, int c_, int k_, bool pd)
      : rd2(), xpd(), n(n_), c(c_), k(k_), lda(n_ + 1), ldz(z_stride(c_)) {
    L = p;            p += (size_t)n * lda;
    rd = p;           p += n;
    if (pd) { rd2 = p; p += n; }
    Z = p;            p += (size_t)n * ldz;
    D = p;            p += (size_t)c * c;
    vq = p;           p += n;
    if (pd) { xpd = p; p += n; }
    bh = p;           p += c;
    gid = p;          p += c;
    lam = p;          p += c;
    lnew = p;         p += c;
    mu = p;           p += k;
    end = p;
  }
};

// sum_t a[t sa] b[t sb] over t < len: four partial sums, each batch of
// four terms loaded before it is summed, so the loads overlap.
template <typename T>
__device__ inline T dot4(const T* a, int sa, const T* b, int sb, int len) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int t = 0;
  for (; t + 3 < len; t += 4) {
    const T a0 = a[t * sa], a1 = a[(t + 1) * sa], a2 = a[(t + 2) * sa],
            a3 = a[(t + 3) * sa];
    const T b0 = b[t * sb], b1 = b[(t + 1) * sb], b2 = b[(t + 2) * sb],
            b3 = b[(t + 3) * sb];
    s0 += a0 * b0;
    s1 += a1 * b1;
    s2 += a2 * b2;
    s3 += a3 * b3;
  }
  for (; t < len; ++t) s0 += a[t * sa] * b[t * sb];
  return (s0 + s1) + (s2 + s3);
}

// The factor of s.L in layout Lay (with rd) and Z's columns [c0, c1) <-
// L^-1 Z beside it (SubstRider); columns beyond the rider's two per lane
// (c1 - c0 > 64) after it, dot form.  Ends with __syncwarp.
template <typename T, typename Lay>
__device__ void factor_and_substitute(const Sys<T*>& s, Lay, T* rd, T* Z,
                                      int ldz, int c0, int c1, T* jq,
                                      int lane) {
  const int n = s.n, lda = s.lda;
  T* L = s.L;
  warp_cholesky(L, lda, rd, n, lane,
                SubstRider<T>(Z, ldz, c0, c1, n, lane, s.vq, jq), Lay());
  for (int col = c0 + 64 + lane; col < c1; col += 32) {
    T q = T(0);
    for (int j = 0; j < n; ++j) {
      T v = Z[j * ldz + col];
      q += v * s.vq[j];
      for (int k = 0; k < j; ++k)
        v -= L[Lay::at(j, k, lda)] * Z[k * ldz + col];
      Z[j * ldz + col] = v * rd[j];
    }
    if (jq != nullptr) jq[col - 1] = q;
  }
  __syncwarp();
}

// D = Z_c^T Z_c over the columns 1..c of Z: the pairs (a, b), b <= a, of
// the lower triangle (p = a (a + 1) / 2 + b) spread over the lanes, two
// pairs at a time, each a dot of length n, written to both triangles.
// Ends with __syncwarp.
template <typename T>
__device__ void warp_gram(const Sys<T*>& s, int lane) {
  const int n = s.n, c = s.c, ldz = s.ldz, np = c * (c + 1) / 2;
  const T* Z = s.Z + 1;
  auto advance = [](int& a, int& b, int by) {
    b += by;
    while (b > a) { b -= a + 1; ++a; }
  };
  int a0 = 0, b0 = 0;
  advance(a0, b0, lane);
  for (int p = lane; p < np; p += 64) {
    int a1 = a0, b1 = b0;
    advance(a1, b1, 32);
    const bool h1 = p + 32 < np;
    T acc0 = T(0), acc1 = T(0);
    for (int d = 0; d < n; ++d) {
      const T* zd = Z + d * ldz;
      acc0 += zd[a0] * zd[b0];
      if (h1) acc1 += zd[a1] * zd[b1];
    }
    s.D[a0 * c + b0] = acc0;
    s.D[b0 * c + a0] = acc0;
    if (h1) {
      s.D[a1 * c + b1] = acc1;
      s.D[b1 * c + a1] = acc1;
    }
    a0 = a1;
    b0 = b1;
    advance(a0, b0, 32);
  }
  __syncwarp();
}

// From Z = [z0 | Z_c], D and J qvel in bh: bhat, the preconditioner, the
// projected-Jacobi sweep (lanes over rows; D read by columns, which is its
// rows), y = z0 + Z_c lam into column 0, x = L^-T y, and v_new = qvel + x
// to ``out`` (one system's n values).
template <typename T>
__device__ void warp_contact_finish(const Sys<T*>& s,
                                    const T* __restrict__ target, int iters,
                                    T relax, T* __restrict__ out, int lane) {
  const int n = s.n, c = s.c, k = s.k, ldz = s.ldz;
  T* Z = s.Z;
  for (int r = lane; r < c; r += 32) {
    const T zb = dot4(Z + 1 + r, ldz, Z, ldz, n);
    T r0 = T(0), r1 = T(0);
    int j = 0;
    for (; j + 1 < c; j += 2) {
      r0 += xabs(s.D[j * c + r]);
      r1 += xabs(s.D[(j + 1) * c + r]);
    }
    if (j < c) r0 += xabs(s.D[j * c + r]);
    s.bh[r] = s.bh[r] + zb - target[r];
    s.gid[r] = relax / ((r0 + r1) + T(1e-9));
    s.lam[r] = T(0);
  }
  STAMP(ST_PREP);
  __syncwarp();
  for (int it = 0; it < iters; ++it) {
    for (int r = lane; r < c; r += 32) {
      const T g = dot4(s.D + r, c, s.lam, 1, c);
      s.lnew[r] = s.lam[r] - (g + s.bh[r]) * s.gid[r];
    }
    __syncwarp();
    for (int r = lane; r < c; r += 32) {
      const T x = s.lnew[r];
      if (r < 2 * k) {
        const int e = r < k ? r : r - k;
        const T lim = s.mu[e] * xmax(s.lnew[2 * k + e], T(0));
        s.lam[r] = xmin(xmax(x, -lim), lim);
      } else {
        s.lam[r] = xmax(x, T(0));
      }
    }
    __syncwarp();
  }
  STAMP(ST_SWEEP);
  for (int i = lane; i < n; i += 32)
    Z[i * ldz] += dot4(Z + i * ldz + 1, 1, s.lam, 1, c);
  __syncwarp();
  warp_ltsolve_vec(s.L, s.lda, s.rd, Z, ldz, n, lane);
  for (int i = lane; i < n; i += 32) out[i] = s.vq[i] + Z[i * ldz];
  STAMP(ST_VELOCITY);
}

// Shared <- device memory without a register round trip (cp.async); the
// copies are complete and visible to the warp after copy_wait.
template <typename T>
__device__ inline void copy_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ inline void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Start copying the lower triangle of one system's n x n matrix (all that
// the factor reads, as the plain version's Cholesky does) into the square
// L (row stride n + 1) in layout Lay: row-major reads of the matrix, and
// writes to a row of L (RowMajor) or down a column (UpperShifted; odd
// stride, no bank conflict).
template <typename T, typename Lay>
__device__ void load_matrix(T* L, const T* __restrict__ m, int n, Lay,
                            int lane) {
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, k = e - i * n;
    if (k <= i) copy_async(L + Lay::at(i, k, n + 1), m + e);
  }
}

// After copy_wait: L[i][i] += dt kdd[i][col] in layout Lay.
template <typename T, typename Lay>
__device__ void add_diagonal(T* L, int n, Lay, const T* __restrict__ kdd,
                             int col, T dt, int lane) {
  for (int i = lane; i < n; i += 32)
    L[Lay::at(i, i, n + 1)] += dt * kdd[2 * i + col];
  __syncwarp();
}

// Start copying the J^T columns of Z (1..c), qvel and mu of one system.
template <typename T>
__device__ void load_contacts(const Sys<T*>& s, const T* __restrict__ jf,
                              const T* __restrict__ qvel,
                              const T* __restrict__ mu, int lane) {
  const int n = s.n;
  for (int e = lane; e < s.c * n; e += 32) {
    const int r = e / n, i = e - r * n;
    copy_async(s.Z + i * s.ldz + 1 + r, jf + e);
  }
  for (int i = lane; i < n; i += 32) copy_async(s.vq + i, qvel + i);
  for (int r = lane; r < s.k; r += 32) copy_async(s.mu + r, mu + r);
}

template <typename T>
__global__ void __launch_bounds__(32 * MAX_SPB)
fused_contact_kernel(const T* __restrict__ a, const T* __restrict__ qfrc,
                     const T* __restrict__ qvel, const T* __restrict__ jf,
                     const T* __restrict__ target, const T* __restrict__ mu,
                     T* __restrict__ out, int batch, int n, int c, int k,
                     int iters, T dt, T relax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t sys = (size_t)blockIdx.x * (blockDim.x >> 5) + w;
  if (sys >= (size_t)batch) return;          // no block barrier below
  STAMP(ST_START);
  const Sys<T*> s(reinterpret_cast<T*>(smem_raw)
                  + w * Sys<size_t>(0, n, c, k, false).end, n, c, k, false);
  load_matrix(s.L, a + sys * n * n, n, RowMajor(), lane);
  load_contacts(s, jf + sys * c * n, qvel + sys * n, mu + sys * k, lane);
  for (int i = lane; i < n; i += 32) s.Z[i * s.ldz] = dt * qfrc[sys * n + i];
  copy_wait();
  STAMP(ST_LOAD);
  factor_and_substitute(s, RowMajor(), s.rd, s.Z, s.ldz, 0, 1 + c, s.bh,
                        lane);
  STAMP(ST_FACTOR);
  warp_gram(s, lane);
  STAMP(ST_GRAM);
  warp_contact_finish(s, target + sys * c, iters, relax, out + sys * n,
                      lane);
}

// K4's PD half for one system: A_pd (in s.L, layout Lay) factored with
// reciprocal diagonal rdp, xpd <- A_pd^-1 rhspd, then the clamped torque
// and dt qfrc into column 0 of Z, lanes over dofs.
template <typename T, typename Lay>
__device__ void pd_torque(const Sys<T*>& s, Lay, T* rdp,
                          const T* __restrict__ e, const T* __restrict__ jkp,
                          const T* __restrict__ jkd,
                          const T* __restrict__ tlim,
                          const T* __restrict__ gear,
                          const T* __restrict__ qfb,
                          const T* __restrict__ qvel, T dt, int lane) {
  const int n = s.n;
  factor_and_substitute(s, Lay(), rdp, s.xpd, 1, 0, 1, (T*)nullptr, lane);
  STAMP(ST_PD_FACTOR);
  warp_ltsolve_vec(s.L, s.lda, rdp, s.xpd, 1, n, lane, Lay());
  STAMP(ST_PD_BACK);
  for (int i = lane; i < n; i += 32) {
    const T lim = tlim[i];
    T tq = -jkp[i] * e[i] - jkd[i] * (qvel[i] + dt * s.xpd[i]);
    tq = xmin(xmax(tq, -lim), lim);
    s.Z[i * s.ldz] = (qfb[i] + tq * gear[i]) * dt;
  }
  STAMP(ST_TORQUE);
  __syncwarp();
}

__device__ inline void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}
__device__ inline void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// Two warps per system; the pair of slot ``slot`` joins on barrier
// 1 + slot (id 0 is __syncthreads', unused here).
template <typename T>
__global__ void __launch_bounds__(64 * MAX_PAIRS)
pd_fused_kernel(const T* __restrict__ mmat, const T* __restrict__ kdd,
                const T* __restrict__ rhspd, const T* __restrict__ e,
                const T* __restrict__ jkp, const T* __restrict__ jkd,
                const T* __restrict__ tlim, const T* __restrict__ gear,
                const T* __restrict__ qfb, const T* __restrict__ qvel,
                const T* __restrict__ jf, const T* __restrict__ target,
                const T* __restrict__ mu, T* __restrict__ out, int batch,
                int n, int c, int k, int iters, T dt, T relax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, slot = w >> 1;
  const size_t sys = (size_t)blockIdx.x * (blockDim.x >> 6) + slot;
  if (sys >= (size_t)batch) return;          // both warps of the pair
  STAMP(ST_START);
  const Sys<T*> s(reinterpret_cast<T*>(smem_raw)
                  + slot * Sys<size_t>(0, n, c, k, true).end, n, c, k, true);
  const size_t v = sys * n;
  if ((w & 1) == 0) {                        // PD: factor, solve, torque
    load_matrix(s.L, mmat + v * n, n, UpperShifted(), lane);
    for (int i = lane; i < n; i += 32) copy_async(s.xpd + i, rhspd + v + i);
    copy_wait();
    add_diagonal(s.L, n, UpperShifted(), kdd + 2 * v, 0, dt, lane);
    STAMP(ST_LOAD);
    pd_torque(s, UpperShifted(), s.rd2, e + v, jkp + v, jkd + v, tlim + v,
              gear + v, qfb + v, qvel + v, dt, lane);
    pair_arrive(1 + slot);
    return;
  }
  // dynamics: factor, J^T columns, D; then z0 and the contact solve
  load_matrix(s.L, mmat + v * n, n, RowMajor(), lane);
  load_contacts(s, jf + sys * c * n, qvel + v, mu + sys * k, lane);
  copy_wait();
  add_diagonal(s.L, n, RowMajor(), kdd + 2 * v, 1, dt, lane);
  STAMP(ST_LOAD);
  factor_and_substitute(s, RowMajor(), s.rd, s.Z, s.ldz, 1, 1 + c, s.bh,
                        lane);
  STAMP(ST_FACTOR);
  warp_gram(s, lane);
  STAMP(ST_GRAM);
  pair_sync(1 + slot);
  STAMP(ST_WAIT);
  warp_lsolve_vec(s.L, s.lda, s.rd, s.Z, s.ldz, n, lane);
  STAMP(ST_Z0);
  warp_contact_finish(s, target + sys * c, iters, relax, out + v, lane);
}

// At most ``spb`` systems per block, fewer for a small batch, so that its
// blocks spread over the SMs: one system per block up to one per SM.
static int spread(int spb, int batch) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (batch + sms - 1) / sms;
  return want < spb ? want : spb;
}

static bool bad_dims(int batch, int n, int c, int k, int iters) {
  return batch < 1 || n < 1 || c < 1 || k < 0 || 3 * k > c || iters < 0;
}

// Bytes of one system and systems per block (0: one does not fit).
template <typename T>
static size_t sys_bytes(int n, int c, int k, bool pd) {
  return Sys<size_t>(0, n, c, k, pd).end * sizeof(T);
}

template <typename T>
static int launch_fused(const T* a, const T* qfrc, const T* qvel, const T* jf,
                        const T* target, const T* mu, T* out, int batch, int n,
                        int c, int k, int iters, double dt, double relax,
                        void* stream) {
  if (bad_dims(batch, n, c, k, iters)) return -1;
  const size_t one = sys_bytes<T>(n, c, k, false);
  int spb = systems_per_block(one, MAX_SPB);
  if (spb == 0) return -2;
  spb = spread(spb, batch);
  const int err = opt_in_shared(fused_contact_kernel<T>, spb * one);
  if (err != 0) return err;
  fused_contact_kernel<T><<<(batch + spb - 1) / spb, 32 * spb, spb * one,
                            (cudaStream_t)stream>>>(
      a, qfrc, qvel, jf, target, mu, out, batch, n, c, k, iters, T(dt),
      T(relax));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_pd(const T* mmat, const T* kdd, const T* rhspd, const T* e,
                     const T* jkp, const T* jkd, const T* tlim, const T* gear,
                     const T* qfb, const T* qvel, const T* jf, const T* target,
                     const T* mu, T* out, int batch, int n, int c, int k,
                     int iters, double dt, double relax, void* stream) {
  if (bad_dims(batch, n, c, k, iters)) return -1;
  const size_t one = sys_bytes<T>(n, c, k, true);
  int spb = systems_per_block(one, MAX_PAIRS);
  if (spb == 0) return -2;
  spb = spread(spb, batch);
  const int err = opt_in_shared(pd_fused_kernel<T>, spb * one);
  if (err != 0) return err;
  pd_fused_kernel<T><<<(batch + spb - 1) / spb, 64 * spb,
                       spb * one, (cudaStream_t)stream>>>(
      mmat, kdd, rhspd, e, jkp, jkd, tlim, gear, qfb, qvel, jf, target, mu,
      out, batch, n, c, k, iters, T(dt), T(relax));
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

// Resources of K3 or K4 for (n, c, k) and dtype (0 float, 1 double):
// out[0..4] as kernel_occupancy (cholesky.cuh), out[5] warps per system.
template <typename T>
static int fused_occupancy(bool pd, int n, int c, int k, int* out) {
  if (bad_dims(1, n, c, k, 0)) return -1;
  out[5] = pd ? 2 : 1;
  if (pd) {
    const size_t one = sys_bytes<T>(n, c, k, true);
    return kernel_occupancy(pd_fused_kernel<T>,
                            systems_per_block(one, MAX_PAIRS), 64, one,
                            out);
  }
  const size_t one = sys_bytes<T>(n, c, k, false);
  return kernel_occupancy(fused_contact_kernel<T>,
                          systems_per_block(one, MAX_SPB), 32, one, out);
}

extern "C" int egopose_fused_contact_occupancy(int n, int c, int k, int f64,
                                               int* out) {
  return f64 ? fused_occupancy<double>(false, n, c, k, out)
             : fused_occupancy<float>(false, n, c, k, out);
}

extern "C" int egopose_pd_fused_occupancy(int n, int c, int k, int f64,
                                          int* out) {
  return f64 ? fused_occupancy<double>(true, n, c, k, out)
             : fused_occupancy<float>(true, n, c, k, out);
}
