// Substep-resident stable-PD control step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel egopose_tpu/physics/substep_pallas.py::
// _substep_kernel (launched by _substep_tpu through make_substep_step).  One
// launch runs one whole 30 Hz control step -- n_frames substeps grouped by
// the prep-refresh cadence R, the remainder group last -- for a batch of
// environments:
//
//   per group: FK -> floor top-K and capsule/box pair narrowphase with
//              top-KP selection -> contact Jacobian (as J^T) -> CRBA in
//              compressed ancestor-slot rows -> RNEA bias -> sparse tree
//              LDL^T of the PD and dynamics systems -> L^-1 of both ->
//              Y = L^-T J^T -> Delassus Y^T D^-1 Y
//   per substep: joint limits + PD rhs -> PD solve -> torque clamp ->
//              u = D^-1 L^-T (dt qfrc) -> residual Y^T (L v + u) ->
//              projected-Jacobi sweep -> v += L^-1 (u + D^-1 Y lam) ->
//              semi-implicit integration
//
// Design.  One thread block of 128 threads per environment, the working set
// in (dynamic) shared memory.  What bounds it is not bytes or flops (~2 KB
// and ~1-2 MFLOP per environment and control step) but a long chain of
// small dependent stages per environment, so the design keeps that chain
// short and keeps enough environments in flight:
//
// - Footprint.  The block's arrays are placed by physics/substep.py::
//   smem_layout, which overlays arrays live only in the prep (FK, candidate,
//   CRBA and RNEA intermediates) on those written later (L^-1, Delassus
//   matrix, per-substep vectors), and the Jacobian is not kept beside Y
//   in the substeps: 24.0 KB in float (47 KB in double) for the 58-dof
//   humanoid.
//   With __launch_bounds__(128, 8) (64 registers a thread) 8 float blocks
//   fit one SM, so B = 1024 runs in one wave on the H100's 132 SMs.
// - Short chains.  The factor runs by the levels of the dofs' elimination
//   tree (28 for the humanoid, not its 58 dofs), from item tables built on
//   the host (substep.py::factor_schedule): an item updates one value, the
//   items of one target run in one thread in a row, so no two threads
//   write one value and nothing is reduced across threads; each thread
//   reads its items three rows ahead.  The tree factor has no fill and a
//   row's ancestor list holds all its ancestors, so L^-1 has L's slots:
//   once per group the kernel forms L^-1 of both factors, one row per
//   thread and all rows at once (from L^-1 L = I a row needs only itself
//   and L), and every solve of the substeps, and Y = L^-T J^T, is then a
//   gather per dof (per dof and active column for Y) in parallel: a
//   column of L^-1 for L^-T, a row for L^-1.
// - One L^-1 product less per substep: the velocity update is
//   v + L^-1 D^-1 (L^-T dt qfrc + Y lam) and the contact residual
//   J v_pred = Y^T (L v + D^-1 L^-T dt qfrc), so the dynamics solve stops
//   after D^-1 L^-T and J is not kept once Y is formed.
// - Contacts: Y skips the inactive contact columns (an inactive row of J
//   is zero, so its lambda is exactly 0 and skipping it is exact), the
//   Delassus matrix and the sweep run over active rows only, and the sweep
//   reads G by column (G is symmetric), so its lanes hit distinct banks.
// - The per-dof floats the substep loop reads (gains, control, limits,
//   damping, stiffness, gear, torque limit) stay in the registers of the
//   thread that owns the dof; the warps that own no dof form L v meanwhile.
//
// The dense branch (Dims.dense; ContactParams.sparse_ldl=False) ports the
// TPU kernel's dense-Cholesky branch (substep_pallas.py:739-830): the prep
// runs every substep whatever prep_refresh says, A_pd = M + dt diag(kd) and
// A_dyn = M + dt diag(damping) are factored (cholesky.cuh's warp_cholesky,
// pivots floored at 1e-12, each factor reading its own lower triangle, as
// linalg_pallas.py::_factor_multi), and the contact solve runs forward
// only, as K4's (fused_contact.cu), since J A_dyn^-1 J^T = Y^T Y with
// A_dyn = L L^T and Y = L^-1 J^T:
//   factor    A_pd on warp 0 with the PD column's forward half riding on
//             it; A_dyn on warp 1 with the J^T columns riding on it
//             (SubstRider: Y = L^-1 J^T in place, J v read off the columns
//             as they pass)
//   gram      the PD column's back substitution on warp 0; beside it
//             D = Y^T Y on the active rows (lower triangle, mirrored) on
//             warps 1-3
//   torque    torque, clamp, dt qfrc; the sweep's row scale from D
//   z0 ...    on warp 0: z0 = L^-1 (dt qfrc), the residual
//             J v + Y^T z0 - target, the sweep, and v_new = v + L^-T (z0 +
//             Y lam) by one back substitution
// W = A_dyn^-1 J^T and J W are never formed.  Both factors share one
// n x lda square (lda = (n + 1) | 1): A_dyn's L in the lower triangle,
// A_pd's transposed into the upper one (cholesky.cuh's UpperShifted).  The
// square is assembled once the CRBA/RNEA intermediates it overlays are
// dead, straight from the CRBA rows (M[i][j] = fcrb_i . s_j where j is an
// ancestor of i, a host-built bit table, else 0), so every entry either
// factor reads is written each substep.  It is a second instantiation of
// the same body (substep_dense_kernel): 24.0 KB of shared memory in
// float (47.8 KB in double) for the 58-dof humanoid; with
// __launch_bounds__(128, 8) 8 float blocks fit one SM, one wave at
// B = 1024, as the sparse branch.
//
// The model is not baked into the code: every table arrives as device
// memory (itab: int32, ftab: T) described by the Dims offsets, which the
// Python wrapper builds once per model.  No --use_fast_math: the 58-dof
// system is stiff.  Built with -DEGOPOSE_STAGE_CLOCKS, thread 0 of every
// block sums the clock64() cycles of each stage (a barrier closes each)
// into clocks[env * N_STAGES + stage]; the main path's library has no
// clock code.  Built with -DEGOPOSE_POISON, the dense branch honours
// Dims.poison (a test's NaN fills); the main path's library has no poison
// code either.
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "cholesky.cuh"

#define NT 128

enum Stage {
  ST_LOAD, ST_FK, ST_DYNAMICS, ST_NARROW, ST_SELECT, ST_FACTOR, ST_INVERSE,
  ST_Y, ST_DELASSUS, ST_PD, ST_TORQUE, ST_DYN_SOLVE, ST_RESIDUAL, ST_SWEEP,
  ST_VELOCITY, ST_INTEGRATE, ST_STORE, ST_GRAM, ST_Z0, N_STAGES
};
#ifdef EGOPOSE_STAGE_CLOCKS
#define STAMP(st)                                    \
  do {                                               \
    __syncthreads();                                 \
    if (tid == 0) {                                  \
      const long long now_ = clock64();              \
      clk[st] += now_ - clk_last;                    \
      clk_last = now_;                               \
    }                                                \
  } while (0)
#else
#define STAMP(st) \
  do {            \
  } while (0)
#endif

// Field order: physics/substep.py::DIM_FIELDS.
struct Dims {
  int nb, nd, nq, nu, ncp, npair, nbpair, k, kp, c3, nnz, nlevel;
  int n_frames, prep_refresh, iters, dense, lda;
  int i_parent, i_dof_body, i_hinge0, i_nhinge, i_lvl_off, i_lvl_body;
  int i_path_off, i_path_idx, i_vp_off, i_vp_idx, i_desc_off, i_desc_idx;
  int i_anc_off, i_anc_idx, i_ent_row, i_banc, i_cp_body;
  int i_p_b1, i_p_b2, i_bp_seg, i_bp_box;
  int i_height, i_fac_a, i_fac_b, i_fac_row, i_col_off, i_col_slot;
  int i_col_row, i_anc_base, n_fac, i_dmask;
  int f_body_pos, f_body_ipos, f_mass, f_inertia, f_axis, f_anchor;
  int f_armature, f_damping, f_stiffness, f_lo, f_hi, f_limited, f_gear;
  int f_gravity, f_cp_local, f_cp_radius, f_cp_mu;
  int f_p_a1, f_p_b1, f_p_a2, f_p_b2, f_p_rsum, f_p_rdiff;
  int f_bp_a, f_bp_b, f_bp_rseg, f_bp_pos, f_bp_quat, f_bp_half, f_scal;
  int l_q, l_v, l_mpd, l_mdyn, l_ipd, l_idyn, l_bias, l_lidyn, l_y, l_tgt,
      l_mu;
  int l_xpos, l_xquat, l_s, l_pall, l_phiall, l_pphi, l_pn, l_pp, l_selphi;
  int l_com, l_ic, l_io, l_smom, l_sio, l_smass, l_sq, l_cj, l_fcrb, l_fb;
  int l_dpd, l_ddyn, l_lipd, l_abase, l_jt, l_g, l_gid, l_rhs, l_z, l_u;
  int l_w, l_lam;
  int l_asq, l_rpd, l_rdyn, l_xpd, l_jq, l_xdyn;
  int l_sel, l_act, l_nact, l_amask, l_total, l_ints;
  // Read by the -DEGOPOSE_POISON build only (tests).  Last: under the
  // 64-register bound ptxas's spills and schedule of the sparse branch move
  // with this struct's layout (5% at B = 1024, PERF.md section 6); with
  // poison here it allocates as it did before the field existed.
  int poison;
};

// Bytes of one block's dynamic shared memory: l_total values of T, then
// l_ints ints.
template <typename T>
__host__ __device__ inline size_t smem_bytes(const Dims& d) {
  return (size_t)d.l_total * sizeof(T) + (size_t)d.l_ints * sizeof(int);
}

// Factor item flags of substep.py (FA_*).
#define FA_FIRST (1 << 13)
#define FA_LAST (1 << 14)
#define FA_FINAL (1 << 15)
#define FA_SCALE (1 << 23)

// ---------------------------------------------------------------------------
// math for float and double (explicit, so the float build never promotes;
// xsqrt, xabs, xmax and xmin come from cholesky.cuh)
// ---------------------------------------------------------------------------

__device__ inline float xsin(float x) { return sinf(x); }
__device__ inline double xsin(double x) { return sin(x); }
__device__ inline float xcos(float x) { return cosf(x); }
__device__ inline double xcos(double x) { return cos(x); }

// ---------------------------------------------------------------------------
// small vector helpers (formulas of ops/quat.py)
// ---------------------------------------------------------------------------

template <typename T>
__device__ inline void cross3(const T* a, const T* b, T* o) {
  T x = a[1] * b[2] - a[2] * b[1];
  T y = a[2] * b[0] - a[0] * b[2];
  T z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

template <typename T>
__device__ inline void qrot(const T* q, const T* v, T* o) {
  T t[3], c[3];
  cross3(q + 1, v, t);
  t[0] *= T(2); t[1] *= T(2); t[2] *= T(2);
  cross3(q + 1, t, c);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + q[0] * t[i] + c[i];
}

template <typename T>
__device__ inline void qrot_inv(const T* q, const T* v, T* o) {
  T qc[4] = {q[0], -q[1], -q[2], -q[3]};
  qrot(qc, v, o);
}

template <typename T>
__device__ inline void qmul(const T* a, const T* b, T* o) {
  T w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  T x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  T y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  T z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

template <typename T>
__device__ inline T dot6(const T* a, const T* b) {
  T r = T(0);
  for (int i = 0; i < 6; ++i) r += a[i] * b[i];
  return r;
}

// symmetric 3x3 stored as (00, 01, 02, 11, 12, 22)
__device__ inline int sym(int i, int j) {
  if (i > j) { int t = i; i = j; j = t; }
  return i == 0 ? j : (i == 1 ? 2 + j : 5);
}

template <typename T>
__device__ inline void sym_mv(const T* m, const T* w, T* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = m[sym(i, 0)] * w[0] + m[sym(i, 1)] * w[1] + m[sym(i, 2)] * w[2];
}

// spatial inertia (mass, com, com-frame world inertia ic) times v
template <typename T>
__device__ inline void apply_inertia(T mass, const T* c, const T* ic,
                                     const T* v, T* o) {
  T wc[3], p[3], n[3], cp[3];
  cross3(v, c, wc);
  for (int i = 0; i < 3; ++i) p[i] = mass * (v[3 + i] + wc[i]);
  sym_mv(ic, v, n);
  cross3(c, p, cp);
  for (int i = 0; i < 3; ++i) { o[i] = n[i] + cp[i]; o[3 + i] = p[i]; }
}

template <typename T>
__device__ inline T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Top-kk of val[0..n) by one warp: values descending, ties to the lowest
// index (engine.top_k_desc).  Selected entries are overwritten with -inf.
template <typename T>
__device__ void warp_topk(T* val, int n, int kk, int* out_idx, T* out_val,
                          int lane) {
  for (int r = 0; r < kk; ++r) {
    T best = -INFINITY;
    int bi = n;
    for (int i = lane; i < n; i += 32) {
      T x = val[i];
      if (x > best || (x == best && i < bi)) { best = x; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      T ob = __shfl_down_sync(0xffffffffu, best, off);
      int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    if (lane == 0) {
      out_idx[r] = bi;
      out_val[r] = best;
      if (bi < n) val[bi] = -INFINITY;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// the tree LDL^T by levels (physics/substep.py builds the item tables) and
// the products with L^-1
// ---------------------------------------------------------------------------

// sum_{s < m} li[e0 + s] * b[idx[e0 + s]]: row k of L^-1 (e0 = anc_off[k],
// idx = anc_idx) against b, or with col_slot/col_row a column of L^-1; four
// partial sums so the loads of four terms overlap.
template <typename T>
__device__ inline T gather_dot(const T* li, const T* b,
                               const int* __restrict__ slot,
                               const int* __restrict__ idx, int e0, int m) {
  T p0 = T(0), p1 = T(0), p2 = T(0), p3 = T(0);
  int i = e0;
  const int end = e0 + m;
  for (; i + 4 <= end; i += 4) {
    p0 += li[slot ? __ldg(slot + i) : i] * b[__ldg(idx + i)];
    p1 += li[slot ? __ldg(slot + i + 1) : i + 1] * b[__ldg(idx + i + 1)];
    p2 += li[slot ? __ldg(slot + i + 2) : i + 2] * b[__ldg(idx + i + 2)];
    p3 += li[slot ? __ldg(slot + i + 3) : i + 3] * b[__ldg(idx + i + 3)];
  }
  for (; i < end; ++i) p0 += li[slot ? __ldg(slot + i) : i] * b[__ldg(idx + i)];
  return (p0 + p1) + (p2 + p3);
}

// The whole block: both systems' tree LDL^T in place (ldl_pallas.ldl_factor
// by elimination-tree levels).  mpd/mdyn hold the compressed rows, dpd/ddyn
// the diagonals; ipd/idyn hold 1/D of the leaves on entry and of every dof
// on return.  Pass p updates every entry of the rows above the dofs of
// height p, each entry gathering over those dofs (target -= (rows[e1] *
// invd[k]) * rows[e2]), stores 1/D of the dofs whose diagonal got its last
// update, and scales the rows of height p-1 to L's rows; one barrier per
// pass.  Each thread's items stream through a queue loaded three rows
// ahead, across pass boundaries.
template <typename T>
__device__ void block_factor(T* mpd, T* mdyn, T* dpd, T* ddyn, T* ipd,
                             T* idyn, const int* __restrict__ ta,
                             const int* __restrict__ tb,
                             const int* __restrict__ row_off, int npass,
                             int nnz, int tid) {
  const int nrow = __ldg(row_off + npass);
  int qa[3], qb[3];
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    qa[u] = u < nrow ? __ldg(ta + (size_t)u * NT + tid) : -1;
    qb[u] = u < nrow ? __ldg(tb + (size_t)u * NT + tid) : 0;
  }
  int r = 0, r1n = __ldg(row_off + 1);
  for (int p = 0; p < npass; ++p) {
    const int r1 = r1n;
    if (p + 1 < npass) r1n = __ldg(row_off + p + 2);
    T acc0 = T(0), acc1 = T(0);
    for (; r < r1; ++r) {
      const int a = qa[0], b = qb[0];
      qa[0] = qa[1]; qb[0] = qb[1];
      qa[1] = qa[2]; qb[1] = qb[2];
      qa[2] = r + 3 < nrow ? __ldg(ta + (size_t)(r + 3) * NT + tid) : -1;
      qb[2] = r + 3 < nrow ? __ldg(tb + (size_t)(r + 3) * NT + tid) : 0;
      if (a < 0) continue;
      const int tgt = a & 0x1fff, kk = (a >> 16) & 0x7f;
      if (a & FA_SCALE) {
        mpd[tgt] *= ipd[kk];
        mdyn[tgt] *= idyn[kk];
        continue;
      }
      const int e1 = b & 0xffff, e2 = b >> 16;
      T* p0 = tgt < nnz ? mpd + tgt : dpd + (tgt - nnz);
      T* p1 = tgt < nnz ? mdyn + tgt : ddyn + (tgt - nnz);
      if (a & FA_FIRST) { acc0 = *p0; acc1 = *p1; }
      acc0 -= (mpd[e1] * ipd[kk]) * mpd[e2];
      acc1 -= (mdyn[e1] * idyn[kk]) * mdyn[e2];
      if (a & FA_LAST) {
        *p0 = acc0;
        *p1 = acc1;
        if (a & FA_FINAL) {
          ipd[tgt - nnz] = T(1) / xmax(acc0, T(1e-12));
          idyn[tgt - nnz] = T(1) / xmax(acc1, T(1e-12));
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the contact sweep (both branches)
// ---------------------------------------------------------------------------

// The contact residual of row ``lane`` from J^T-shaped columns (X[dd * c3 +
// r]): sum_dd X[dd][lane] w[dd] - tgt[lane], four partial sums so the loads
// overlap.  Y^T (L v + u) in the sparse branch, Y^T z0 in the dense one.
template <typename T>
__device__ inline T lane_residual(const T* X, const T* w, const T* tgt,
                                  int c3, int nd, int lane) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int dd = 0;
  for (; dd + 4 <= nd; dd += 4) {
    a0 += X[dd * c3 + lane] * w[dd];
    a1 += X[(dd + 1) * c3 + lane] * w[dd + 1];
    a2 += X[(dd + 2) * c3 + lane] * w[dd + 2];
    a3 += X[(dd + 3) * c3 + lane] * w[dd + 3];
  }
  for (; dd < nd; ++dd) a0 += X[dd * c3 + lane] * w[dd];
  return ((a0 + a1) + (a2 + a3)) - tgt[lane];
}

// Projected-Jacobi sweep by one warp, lane r on contact row r
// (linalg_pallas.py::_sweep_lam): g = sum_j G[j][r] lam_j + bh_r over the
// active rows (G holds the symmetric Delassus matrix, so the lanes read
// it by column), lam -= g gid[r], the friction box on
// the 2k tangent rows from their point's normal row, lam >= 0 on the
// normal and pair rows.  The active rows' lam end in lam[].
template <typename T>
__device__ inline void warp_sweep(const T* G, const T* gid, T* lam,
                                  const T* mu, const int* act, int nact,
                                  bool live, T bh_r, int k, int c3,
                                  int iters, int lane) {
  const int r = lane;
  T lr = T(0);
  if (r < c3) lam[r] = T(0);
  __syncwarp();
  const int src = r < k ? 2 * k + r : (r < 2 * k ? r + k : r);
  for (int it = 0; it < iters; ++it) {
    T g = T(0);
    if (live) {              // two partial sums: loads overlap
      T g1 = T(0);
      int ci = 0;
      for (; ci + 2 <= nact; ci += 2) {
        const int j0 = act[ci], j1 = act[ci + 1];
        g += G[j0 * c3 + r] * lam[j0];
        g1 += G[j1 * c3 + r] * lam[j1];
      }
      if (ci < nact) g += G[act[ci] * c3 + r] * lam[act[ci]];
      g = (g + g1) + bh_r;
    }
    T ln = live ? lr - g * gid[r] : T(0);
    const T nv = __shfl_sync(0xffffffffu, ln, src < 32 ? src : 0);
    if (r < 2 * k) {
      const T lim = mu[r % k] * xmax(nv, T(0));
      ln = xmin(xmax(ln, -lim), lim);
    } else {
      ln = xmax(ln, T(0));
    }
    __syncwarp();
    if (live) { lr = ln; lam[r] = ln; }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Offsets of the block's shared arrays (elements of T; ints after l_total).
struct Layout {
  int q, v, mpd, mdyn, ipd, idyn, bias, lidyn, y, tgt, mu;
  int xpos, xquat, s, pall, phiall, pphi, pn, pp, selphi;
  int com, ic, io, smom, sio, smass, sq, cj, fcrb, fb;
  int dpd, ddyn, lipd, abase, jt, g, gid, rhs, z, u, w, lam;
  int asq, rpd, rdyn, xpd, jq, xdyn;
};

__device__ inline Layout layout_of(const Dims& d) {
  Layout L;
  L.q = d.l_q; L.v = d.l_v; L.mpd = d.l_mpd; L.mdyn = d.l_mdyn;
  L.ipd = d.l_ipd; L.idyn = d.l_idyn; L.bias = d.l_bias;
  L.lidyn = d.l_lidyn; L.lipd = d.l_lipd; L.abase = d.l_abase; L.jt = d.l_jt;
  L.y = d.l_y;
  L.tgt = d.l_tgt; L.mu = d.l_mu; L.xpos = d.l_xpos; L.xquat = d.l_xquat;
  L.s = d.l_s; L.pall = d.l_pall; L.phiall = d.l_phiall; L.pphi = d.l_pphi;
  L.pn = d.l_pn; L.pp = d.l_pp; L.selphi = d.l_selphi; L.com = d.l_com;
  L.ic = d.l_ic; L.io = d.l_io; L.smom = d.l_smom; L.sio = d.l_sio;
  L.smass = d.l_smass; L.sq = d.l_sq; L.cj = d.l_cj; L.fcrb = d.l_fcrb;
  L.fb = d.l_fb; L.dpd = d.l_dpd; L.ddyn = d.l_ddyn; L.g = d.l_g;
  L.gid = d.l_gid; L.rhs = d.l_rhs; L.z = d.l_z; L.u = d.l_u; L.w = d.l_w;
  L.lam = d.l_lam;
  L.asq = d.l_asq; L.rpd = d.l_rpd; L.rdyn = d.l_rdyn; L.xpd = d.l_xpd;
  L.jq = d.l_jq; L.xdyn = d.l_xdyn;
  return L;
}

__device__ inline bool in_span(int e, int off, int n) {
  return e >= off && e < off + n;
}

template <typename T, bool DENSE>
__device__ __forceinline__ void substep_body(
    const Dims& d, const int* __restrict__ itab, const T* __restrict__ ftab,
    const T* __restrict__ qpos, const T* __restrict__ qvel,
    const T* __restrict__ ctrl, const T* __restrict__ jkp,
    const T* __restrict__ jkd, const T* __restrict__ tlim,
    T* __restrict__ qpos_out, T* __restrict__ qvel_out,
    long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Layout L = layout_of(d);
  int* ism = reinterpret_cast<int*>(sm + d.l_total);
  int* sel = ism + d.l_sel;              // k floor, kp pair candidates
  int* act = ism + d.l_act;              // active contact rows, ascending
  int* nact_s = ism + d.l_nact;
  int* amask_s = ism + d.l_amask;

  const int env = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nb = d.nb, nd = d.nd, nq = d.nq, nu = d.nu, k = d.k, kp = d.kp;
  const int c3 = d.c3, pp = d.npair + d.nbpair, nnz = d.nnz;

  const int* parent = itab + d.i_parent;
  const int* dof_body = itab + d.i_dof_body;
  const int* hinge0 = itab + d.i_hinge0;
  const int* nhinge = itab + d.i_nhinge;
  const int* lvl_off = itab + d.i_lvl_off;
  const int* lvl_body = itab + d.i_lvl_body;
  const int* path_off = itab + d.i_path_off;
  const int* path_idx = itab + d.i_path_idx;
  const int* vp_off = itab + d.i_vp_off;
  const int* vp_idx = itab + d.i_vp_idx;
  const int* desc_off = itab + d.i_desc_off;
  const int* desc_idx = itab + d.i_desc_idx;
  const int* anc_off = itab + d.i_anc_off;
  const int* anc_idx = itab + d.i_anc_idx;
  const int* ent_row = itab + d.i_ent_row;
  const int* banc = itab + d.i_banc;
  const int* cp_body = itab + d.i_cp_body;
  const int* p_b1 = itab + d.i_p_b1;
  const int* p_b2 = itab + d.i_p_b2;
  const int* bp_seg = itab + d.i_bp_seg;
  const int* bp_box = itab + d.i_bp_box;
  const T* scal = ftab + d.f_scal;
  const T dt = scal[0], margin = scal[1], beta = scal[2], slop = scal[3];
  const T klim = scal[4], blim = scal[5], relax = scal[6];

  T* q = sm + L.q;     T* v = sm + L.v;
  T* xpos = sm + L.xpos; T* xquat = sm + L.xquat; T* com = sm + L.com;
  T* ic = sm + L.ic; T* io = sm + L.io;
  T* s = sm + L.s;     T* fcrb = sm + L.fcrb;
  T* mpd = sm + L.mpd; T* mdyn = sm + L.mdyn;
  T* dpd = sm + L.dpd; T* ddyn = sm + L.ddyn;
  T* ipd = sm + L.ipd; T* idyn = sm + L.idyn; T* bias = sm + L.bias;
  T* Y = sm + L.y;     T* G = sm + L.g;
  T* gid = sm + L.gid; T* tgt = sm + L.tgt;   T* mu = sm + L.mu;
  T* rhs = sm + L.rhs; T* z = sm + L.z; T* u = sm + L.u; T* w = sm + L.w;
  T* lipd = sm + L.lipd; T* lidyn = sm + L.lidyn;
  const int* col_off = itab + d.i_col_off;
  const int* col_slot = itab + d.i_col_slot;
  const int* col_row = itab + d.i_col_row;
  T* lam = sm + L.lam;
  // J^T as the select stage writes it: into Y (sparse), into jt (dense)
  T* JT = DENSE ? sm + L.jt : Y;

#ifdef EGOPOSE_STAGE_CLOCKS
  long long clk[N_STAGES] = {};
  long long clk_last = clock64();
#endif
  // ---- the lane's state; thread dd keeps dof dd's floats in registers --
  for (int i = tid; i < nq; i += NT) q[i] = qpos[(size_t)env * nq + i];
  const bool owner = tid < nd, hinge = owner && tid >= 6;
  const int jh = tid - 6;                 // actuator / joint of a hinge dof
  T kp_r = T(0), kd_r = T(0), ctrl_r = T(0), tlim_r = T(0), gear_r = T(0);
  T lo_r = T(0), hi_r = T(0), lim_r = T(0), damp_r = T(0), stiff_r = T(0);
  if (owner) {
    v[tid] = qvel[(size_t)env * nd + tid];
    damp_r = ftab[d.f_damping + tid];
    stiff_r = ftab[d.f_stiffness + tid];
  }
  if (hinge) {
    kp_r = jkp[(size_t)env * nu + jh];
    kd_r = jkd[(size_t)env * nu + jh];
    ctrl_r = ctrl[(size_t)env * nu + jh];
    tlim_r = tlim[(size_t)env * nu + jh];
    gear_r = ftab[d.f_gear + jh];
    lo_r = ftab[d.f_lo + jh];
    hi_r = ftab[d.f_hi + jh];
    lim_r = ftab[d.f_limited + jh];
  }
  __syncthreads();
  STAMP(ST_LOAD);

  // joint limits, passive forces and stable-PD error of the owner's dof:
  // sets qfb_r and e_r, returns the PD rhs -bias - kp e - kd v
  auto pd_terms = [&](T& qfb_r, T& e_r) -> T {
    const int dd = tid;
    qfb_r = -bias[dd] - damp_r * v[dd];
    if (hinge) {
      const T qj = q[dd + 1], dqj = v[dd];
      const T below = xmax(lo_r - qj, T(0));
      const T above = xmax(qj - hi_r, T(0));
      const T viol = (below > T(0) || above > T(0)) ? T(1) : T(0);
      const T taul = (klim * (below - above) - viol * blim * dqj) * lim_r;
      qfb_r += taul - stiff_r * qj;
      e_r = qj - ctrl_r;
    }
    return -bias[dd] - kp_r * e_r - kd_r * v[dd];
  };
  // semi-implicit integration with the new velocity vn (engine.integrate /
  // quat_integrate); v <- vn
  auto integrate = [&](const T* vn) {
    if (tid == 0) {
      for (int j = 0; j < 3; ++j) q[j] += dt * vn[j];
      const T ew[3] = {vn[3] * dt, vn[4] * dt, vn[5] * dt};
      const T ang = xsqrt(ew[0] * ew[0] + ew[1] * ew[1] + ew[2] * ew[2]);
      const bool safe = ang > T(1e-12);
      const T inv = T(1) / xmax(ang, T(1e-12));
      const T ax[3] = {safe ? ew[0] * inv : T(1), safe ? ew[1] * inv : T(0),
                       safe ? ew[2] * inv : T(0)};
      const T half = ang * T(0.5), sh = xsin(half);
      const T dq[4] = {xcos(half), ax[0] * sh, ax[1] * sh, ax[2] * sh};
      T nq4[4];
      qmul(q + 3, dq, nq4);
      const T nn = xmax(xsqrt(nq4[0] * nq4[0] + nq4[1] * nq4[1] + nq4[2] * nq4[2] + nq4[3] * nq4[3]), T(1e-12));
      for (int j = 0; j < 4; ++j) q[3 + j] = nq4[j] / nn;
    }
    if (owner) {
      if (hinge) q[tid + 1] += dt * vn[tid];
      v[tid] = vn[tid];
    }
  };

  // the dense branch refreshes its prep every substep (substep_pallas.py:739)
  // and keeps the owner's passive force and PD error from its prep here
  const int R = DENSE ? 1 : d.prep_refresh;
  T qfb_d = T(0), e_d = T(0);
  const int n_groups = d.n_frames / R, rem = d.n_frames % R;
  for (int grp = 0; grp < n_groups + (rem ? 1 : 0); ++grp) {
    const int nsub = grp < n_groups ? R : rem;

    // ================= prep: configuration-dependent, once per group =====
    // ---- FK: root, then level by level (engine.fk) ----------------------
    if (tid == 0) {
      T n = xsqrt(q[3] * q[3] + q[4] * q[4] + q[5] * q[5] + q[6] * q[6]);
      n = xmax(n, T(1e-12));
      for (int i = 0; i < 4; ++i) xquat[i] = q[3 + i] / n;
      for (int i = 0; i < 3; ++i) xpos[i] = q[i];
    }
    __syncthreads();
    if (tid < 6) {
      T* sd = s + 6 * tid;
      if (tid < 3) {
        for (int i = 0; i < 6; ++i) sd[i] = T(0);
        sd[3 + tid] = T(1);
      } else {
        T e[3] = {T(0), T(0), T(0)};
        e[tid - 3] = T(1);
        T aw[3], lin[3];
        qrot(xquat, e, aw);
        cross3(xpos, aw, lin);
        for (int i = 0; i < 3; ++i) { sd[i] = aw[i]; sd[3 + i] = lin[i]; }
      }
    }
    for (int lv = 0; lv < d.nlevel; ++lv) {
      for (int i = lvl_off[lv] + tid; i < lvl_off[lv + 1]; i += NT) {
        const int b = lvl_body[i], p = parent[b];
        T wq[4], wt[3], tmp[3];
        for (int j = 0; j < 4; ++j) wq[j] = xquat[4 * p + j];
        qrot(wq, ftab + d.f_body_pos + 3 * b, tmp);
        for (int j = 0; j < 3; ++j) wt[j] = xpos[3 * p + j] + tmp[j];
        for (int h = 0; h < nhinge[b]; ++h) {
          const int dof = hinge0[b] + h;
          const T* a = ftab + d.f_axis + 3 * dof;
          const T* c = ftab + d.f_anchor + 3 * dof;
          T aw[3], anw[3], lin[3];
          qrot(wq, a, aw);
          qrot(wq, c, tmp);
          for (int j = 0; j < 3; ++j) anw[j] = wt[j] + tmp[j];
          cross3(anw, aw, lin);
          for (int j = 0; j < 3; ++j) {
            s[6 * dof + j] = aw[j];
            s[6 * dof + 3 + j] = lin[j];
          }
          const T half = q[dof + 1] * T(0.5);
          const T sn = xsin(half);
          T r[4] = {xcos(half), a[0] * sn, a[1] * sn, a[2] * sn};
          T nq4[4];
          qmul(wq, r, nq4);
          for (int j = 0; j < 4; ++j) wq[j] = nq4[j];
          qrot(wq, c, tmp);
          for (int j = 0; j < 3; ++j) wt[j] = anw[j] - tmp[j];
        }
        for (int j = 0; j < 4; ++j) xquat[4 * b + j] = wq[j];
        for (int j = 0; j < 3; ++j) xpos[3 * b + j] = wt[j];
      }
      __syncthreads();
    }
    STAMP(ST_FK);

    // ---- floor candidates --------------------------------------------
    for (int i = tid; i < d.ncp; i += NT) {
      const int b = cp_body[i];
      T tmp[3];
      qrot(xquat + 4 * b, ftab + d.f_cp_local + 3 * i, tmp);
      T* p = sm + L.pall + 3 * i;
      for (int j = 0; j < 3; ++j) p[j] = xpos[3 * b + j] + tmp[j];
      sm[L.phiall + i] = ftab[d.f_cp_radius + i] - p[2];
    }
    // ---- body-body pair narrowphase (engine.pair_candidates) ------------
    for (int i = tid; i < pp; i += NT) {
      T phi, n[3], p[3];
      if (i < d.npair) {
        const int b1 = p_b1[i], b2 = p_b2[i];
        T a1[3], e1[3], a2[3], e2[3], t[3];
        qrot(xquat + 4 * b1, ftab + d.f_p_a1 + 3 * i, t);
        for (int j = 0; j < 3; ++j) a1[j] = xpos[3 * b1 + j] + t[j];
        qrot(xquat + 4 * b1, ftab + d.f_p_b1 + 3 * i, t);
        for (int j = 0; j < 3; ++j) e1[j] = xpos[3 * b1 + j] + t[j];
        qrot(xquat + 4 * b2, ftab + d.f_p_a2 + 3 * i, t);
        for (int j = 0; j < 3; ++j) a2[j] = xpos[3 * b2 + j] + t[j];
        qrot(xquat + 4 * b2, ftab + d.f_p_b2 + 3 * i, t);
        for (int j = 0; j < 3; ++j) e2[j] = xpos[3 * b2 + j] + t[j];
        T d1[3], d2[3], r[3];
        for (int j = 0; j < 3; ++j) { d1[j] = e1[j] - a1[j]; d2[j] = e2[j] - a2[j]; r[j] = a1[j] - a2[j]; }
        const T A = d1[0] * d1[0] + d1[1] * d1[1] + d1[2] * d1[2];
        const T E = d2[0] * d2[0] + d2[1] * d2[1] + d2[2] * d2[2];
        const T B = d1[0] * d2[0] + d1[1] * d2[1] + d1[2] * d2[2];
        const T C = d1[0] * r[0] + d1[1] * r[1] + d1[2] * r[2];
        const T F = d2[0] * r[0] + d2[1] * r[1] + d2[2] * r[2];
        const T eps = T(1e-12);
        const T denom = A * E - B * B;
        T ss = xmin(xmax((B * F - C * E) / xmax(denom, eps), T(0)), T(1));
        const T tt = xmin(xmax((B * ss + F) / xmax(E, eps), T(0)), T(1));
        ss = xmin(xmax((B * tt - C) / xmax(A, eps), T(0)), T(1));
        T c1[3], c2[3], df[3];
        for (int j = 0; j < 3; ++j) {
          c1[j] = a1[j] + ss * d1[j];
          c2[j] = a2[j] + tt * d2[j];
          df[j] = c1[j] - c2[j];
        }
        const T dist = xsqrt(df[0] * df[0] + df[1] * df[1] + df[2] * df[2]);
        const T dm = xmax(dist, T(1e-9));
        const T rd = ftab[d.f_p_rdiff + i];
        for (int j = 0; j < 3; ++j) {
          n[j] = df[j] / dm;
          p[j] = T(0.5) * (c1[j] + c2[j]) - T(0.5) * rd * n[j];
        }
        phi = ftab[d.f_p_rsum + i] - dist;
      } else {
        const int ib = i - d.npair;
        const int bs = bp_seg[ib], bb = bp_box[ib];
        T qw[4], cb[3], aw[3], bw[3], al[3], bl[3], t[3], h[3];
        qmul(xquat + 4 * bb, ftab + d.f_bp_quat + 4 * ib, qw);
        qrot(xquat + 4 * bb, ftab + d.f_bp_pos + 3 * ib, t);
        for (int j = 0; j < 3; ++j) cb[j] = xpos[3 * bb + j] + t[j];
        qrot(xquat + 4 * bs, ftab + d.f_bp_a + 3 * ib, t);
        for (int j = 0; j < 3; ++j) aw[j] = xpos[3 * bs + j] + t[j];
        qrot(xquat + 4 * bs, ftab + d.f_bp_b + 3 * ib, t);
        for (int j = 0; j < 3; ++j) bw[j] = xpos[3 * bs + j] + t[j];
        for (int j = 0; j < 3; ++j) { t[j] = aw[j] - cb[j]; }
        qrot_inv(qw, t, al);
        for (int j = 0; j < 3; ++j) { t[j] = bw[j] - cb[j]; }
        qrot_inv(qw, t, bl);
        for (int j = 0; j < 3; ++j) h[j] = ftab[d.f_bp_half + 3 * ib + j];
        auto sdist = [&](T tp) -> T {
          T mx = -INFINITY, do2 = T(0);
          for (int j = 0; j < 3; ++j) {
            const T qq = al[j] + tp * (bl[j] - al[j]);
            mx = xmax(mx, xabs(qq) - h[j]);
            const T o = qq - xmin(xmax(qq, -h[j]), h[j]);
            do2 += o * o;
          }
          return mx > T(0) ? xsqrt(do2) : mx;
        };
        // golden-section search, model.golden_min01 step for step
        const T GR = T(0.6180339887498949);
        T a = T(0), bnd = T(1);
        T c = bnd - GR * (bnd - a), dd = a + GR * (bnd - a);
        T fc = sdist(c), fd = sdist(dd);
        for (int it = 0; it < 8; ++it) {
          const bool take = fc < fd;
          a = take ? a : c;
          bnd = take ? dd : bnd;
          const T x_keep = take ? c : dd, f_keep = take ? fc : fd;
          const T x_new = take ? bnd - GR * (bnd - a) : a + GR * (bnd - a);
          const T f_new = sdist(x_new);
          c = take ? x_new : x_keep;
          dd = take ? x_keep : x_new;
          fc = take ? f_new : f_keep;
          fd = take ? f_keep : f_new;
        }
        const T tp = fc < fd ? c : dd;
        T qq[3], dout[3], cc[3], dv[3];
        T mx = -INFINITY, do2 = T(0);
        for (int j = 0; j < 3; ++j) {
          qq[j] = al[j] + tp * (bl[j] - al[j]);
          dout[j] = xabs(qq[j]) - h[j];
          mx = xmax(mx, dout[j]);
          cc[j] = xmin(xmax(qq[j], -h[j]), h[j]);
          dv[j] = qq[j] - cc[j];
          do2 += dv[j] * dv[j];
        }
        const bool outside = mx > T(0);
        const T disto = xsqrt(do2);
        const T invo = T(1) / xmax(disto, T(1e-9));
        // inside: the nearest face, first max as argmax picks it
        const int face = (dout[0] >= dout[1] && dout[0] >= dout[2]) ? 0
                         : (dout[1] >= dout[2] ? 1 : 2);
        T nl[3];
        for (int j = 0; j < 3; ++j)
          nl[j] = outside ? dv[j] * invo
                          : (j == face ? (qq[j] >= T(0) ? T(1) : T(-1)) : T(0));
        const T rseg = ftab[d.f_bp_rseg + ib];
        phi = rseg - (outside ? disto : mx);
        qrot(qw, nl, n);
        T pw[3], cw[3];
        qrot(qw, cc, cw);
        for (int j = 0; j < 3; ++j) {
          pw[j] = aw[j] + tp * (bw[j] - aw[j]);
          p[j] = outside ? T(0.5) * ((cb[j] + cw[j]) + (pw[j] - rseg * n[j]))
                         : pw[j];
        }
      }
      sm[L.pphi + i] = phi;
      for (int j = 0; j < 3; ++j) {
        sm[L.pn + 3 * i + j] = n[j];
        sm[L.pp + 3 * i + j] = p[j];
      }
    }
    __syncthreads();
    STAMP(ST_NARROW);

    // ---- top-K selections (engine.top_k_desc), the active contact rows --
    if (warp == 0) warp_topk(sm + L.phiall, d.ncp, k, sel, sm + L.selphi, lane);
    if (warp == 1 && kp > 0)
      warp_topk(sm + L.pphi, pp, kp, sel + k, sm + L.selphi + k, lane);
    __syncthreads();
    if (tid == 0) {        // rows in block order: tangents, normals, pairs
      int n = 0;
      unsigned mask = 0u;
      for (int r = 0; r < c3; ++r) {
        const T ph = sm[L.selphi + (r < 3 * k ? r % k : r - 2 * k)];
        if (ph > -margin) {
          act[n++] = r;
          mask |= 1u << r;
        }
      }
      *nact_s = n;
      *amask_s = (int)mask;
    }
    // ---- contact Jacobian rows as Y = J^T (engine.contact_blocks) -------
    for (int idx = tid; idx < c3 * nd; idx += NT) {
      const int r = idx / nd, dd = idx % nd;
      const int bd = dof_body[dd];
      const T* sd = s + 6 * dd;
      T val;
      if (r < 3 * k) {
        const int kk = r % k, comp = r / k, pt = sel[kk];
        const T* p = sm + L.pall + 3 * pt;
        T cr[3];
        cross3(sd, p, cr);
        const T on = sm[L.selphi + kk] > -margin ? T(1) : T(0);
        const T msk = banc[cp_body[pt] * nb + bd] ? T(1) : T(0);
        val = (sd[3 + comp] + cr[comp]) * (on * msk);
      } else {
        const int j = r - 3 * k, pi = sel[k + j];
        const T* n = sm + L.pn + 3 * pi;
        const T* p = sm + L.pp + 3 * pi;
        T pxn[3];
        cross3(p, n, pxn);
        int b1, b2;
        if (pi < d.npair) { b1 = p_b1[pi]; b2 = p_b2[pi]; }
        else { b1 = bp_seg[pi - d.npair]; b2 = bp_box[pi - d.npair]; }
        const T sgn = T(banc[b1 * nb + bd] - banc[b2 * nb + bd]);
        const T on = sm[L.selphi + k + j] > -margin ? T(1) : T(0);
        const T row = (sd[3] * n[0] + sd[4] * n[1] + sd[5] * n[2])
                      + (sd[0] * pxn[0] + sd[1] * pxn[1] + sd[2] * pxn[2]);
        val = row * (on * sgn);
      }
      JT[dd * c3 + r] = val;
    }
    for (int r = tid; r < c3; r += NT) {
      T tg = T(0);
      if (r >= 2 * k) {
        const T ph = sm[L.selphi + r - 2 * k];   // floor normals, then pairs
        const T on = ph > -margin ? T(1) : T(0);
        tg = xmin(beta * xmax(ph - slop, T(0)) / dt, T(1)) * on;
      }
      tgt[r] = tg;
      if (r < k) mu[r] = ftab[d.f_cp_mu + sel[r]];
    }
    __syncthreads();
    STAMP(ST_SELECT);
    const int nact = *nact_s;
    const unsigned amask = (unsigned)*amask_s;

    // ---- body coms and world inertias (engine.crba) ---------------------
    for (int b = tid; b < nb; b += NT) {
      const T* xq = xquat + 4 * b;
      T tmp[3];
      qrot(xq, ftab + d.f_body_ipos + 3 * b, tmp);
      T* c = com + 3 * b;
      for (int j = 0; j < 3; ++j) c[j] = xpos[3 * b + j] + tmp[j];
      const T w = xq[0], x = xq[1], y = xq[2], z = xq[3];
      T Rm[9] = {1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                 2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                 2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)};
      const T* I = ftab + d.f_inertia + 9 * b;
      T RI[9];  // R @ I
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          RI[3 * i + j] = Rm[3 * i] * I[j] + Rm[3 * i + 1] * I[3 + j] + Rm[3 * i + 2] * I[6 + j];
      const T m = ftab[d.f_mass + b];
      const T c2 = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
      for (int i = 0; i < 3; ++i)
        for (int l = i; l < 3; ++l) {
          const T v_ic = RI[3 * i] * Rm[3 * l] + RI[3 * i + 1] * Rm[3 * l + 1] + RI[3 * i + 2] * Rm[3 * l + 2];
          ic[6 * b + sym(i, l)] = v_ic;
          io[6 * b + sym(i, l)] = v_ic + m * ((i == l ? c2 : T(0)) - c[i] * c[l]);
        }
    }
    for (int dd = tid; dd < nd; dd += NT)            // s q-dot rows (RNEA)
      for (int j = 0; j < 6; ++j) sm[L.sq + 6 * dd + j] = s[6 * dd + j] * v[dd];
    __syncthreads();

    // ---- subtree sums (CRBA composites) and S-dot q-dot (RNEA) ---------
    for (int b = tid; b < nb; b += NT) {
      T ms = T(0), mom[3] = {T(0), T(0), T(0)}, cio[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int i = desc_off[b]; i < desc_off[b + 1]; ++i) {
        const int c = desc_idx[i];
        const T m = ftab[d.f_mass + c];
        ms += m;
        for (int j = 0; j < 3; ++j) mom[j] += m * com[3 * c + j];
        for (int j = 0; j < 6; ++j) cio[j] += io[6 * c + j];
      }
      sm[L.smass + b] = ms;
      for (int j = 0; j < 3; ++j) sm[L.smom + 3 * b + j] = mom[j];
      for (int j = 0; j < 6; ++j) sm[L.sio + 6 * b + j] = cio[j];
    }
    for (int dd = tid; dd < nd; dd += NT) {
      T vf[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int i = vp_off[dd]; i < vp_off[dd + 1]; ++i)
        for (int j = 0; j < 6; ++j) vf[j] += sm[L.sq + 6 * vp_idx[i] + j];
      const T* b = sm + L.sq + 6 * dd;
      T t1[3], t2[3], t3[3];
      cross3(vf, b, t1);                 // wa x wb
      cross3(vf, b + 3, t2);             // wa x vb
      cross3(vf + 3, b, t3);             // va x wb
      T* o = sm + L.cj + 6 * dd;
      for (int j = 0; j < 3; ++j) { o[j] = t1[j]; o[3 + j] = t2[j] + t3[j]; }
    }
    __syncthreads();

    // ---- composite force rows (CRBA) and body forces (RNEA) ------------
    for (int dd = tid; dd < nd; dd += NT) {
      const int b = dof_body[dd];
      const T* w = s + 6 * dd;
      const T* vo = w + 3;
      const T cm = sm[L.smass + b];
      const T* cmom = sm + L.smom + 3 * b;
      const T* cio = sm + L.sio + 6 * b;
      T t[3], n[3], t2[3];
      cross3(w, cmom, t);
      T* f = fcrb + 6 * dd;
      for (int j = 0; j < 3; ++j) f[3 + j] = cm * vo[j] + t[j];
      sym_mv(cio, w, n);
      cross3(cmom, vo, t2);
      for (int j = 0; j < 3; ++j) f[j] = n[j] + t2[j];
    }
    for (int b = tid; b < nb; b += NT) {
      const T* grav = ftab + d.f_gravity;
      T vb[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      T ab[6] = {T(0), T(0), T(0), -grav[0], -grav[1], -grav[2]};
      T sum_cj[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int i = path_off[b]; i < path_off[b + 1]; ++i) {
        const int e = path_idx[i];
        for (int j = 0; j < 6; ++j) {
          vb[j] += sm[L.sq + 6 * e + j];
          sum_cj[j] += sm[L.cj + 6 * e + j];
        }
      }
      for (int j = 0; j < 6; ++j) ab[j] += sum_cj[j];
      const T m = ftab[d.f_mass + b];
      T iv[6], ia[6], t1[3], t2[3], t3[3];
      apply_inertia(m, com + 3 * b, ic + 6 * b, vb, iv);
      apply_inertia(m, com + 3 * b, ic + 6 * b, ab, ia);
      cross3(vb, iv, t1);                // w x n
      cross3(vb + 3, iv + 3, t2);        // vl x fl
      cross3(vb, iv + 3, t3);            // w x fl
      T* f = sm + L.fb + 6 * b;
      for (int j = 0; j < 3; ++j) {
        f[j] = ia[j] + (t1[j] + t2[j]);
        f[3 + j] = ia[3 + j] + t3[j];
      }
    }
    __syncthreads();

    // ---- mass matrix, diagonals, bias (engine.crba, bias): compressed
    // rows (sparse), or both triangles of the dense square (dense) --------
    if constexpr (DENSE) {
      // A_dyn[r][col] (col < r, RowMajor) and A_pd[col - 1][r] (r + 1 < col
      // <= nd, UpperShifted): M[i][j] = fcrb_i . s_j where j is an ancestor
      // of i (bit j of row i of the dmask table), else 0; the diagonals
      // (col == r, r + 1) by their owners below.  With ``poison`` the square
      // is NaN first, so an entry no factor owns (col > nd) stays NaN and
      // every owned one must be written here, every substep.
      T* asq = sm + L.asq;
      const int lda = d.lda, words = (nd + 31) >> 5;
      const unsigned* dmask =
          reinterpret_cast<const unsigned*>(itab + d.i_dmask);
#ifdef EGOPOSE_POISON
      if (d.poison) {
        for (int e = tid; e < nd * lda; e += NT) asq[e] = T(NAN);
        __syncthreads();
      }
#endif
      for (int e = tid; e < nd * lda; e += NT) {
        const int r = e / lda, col = e - r * lda;
        if (col == r || col == r + 1 || col > nd) continue;
        const int i = col < r ? r : col - 1, j = col < r ? col : r;
        const bool anc = (__ldg(dmask + i * words + (j >> 5)) >> (j & 31)) & 1u;
        asq[e] = anc ? dot6(fcrb + 6 * i, s + 6 * j) : T(0);
      }
    } else {
      for (int e = tid; e < nnz; e += NT) {
        const T val = dot6(fcrb + 6 * ent_row[e], s + 6 * anc_idx[e]);
        mpd[e] = val;
        mdyn[e] = val;
      }
    }
    if (owner) {
      const int dd = tid;
      const T dg = dot6(fcrb + 6 * dd, s + 6 * dd) + ftab[d.f_armature + dd];
      if constexpr (DENSE) {
        sm[L.asq + dd * d.lda + dd] = dg + dt * damp_r;        // A_dyn
        sm[L.asq + dd * d.lda + dd + 1] = dg + dt * kd_r;      // A_pd
      } else {
        dpd[dd] = dg + dt * kd_r;
        ddyn[dd] = dg + dt * damp_r;
        if (itab[d.i_height + dd] == 0) {        // leaves: D is final
          ipd[dd] = T(1) / xmax(dpd[dd], T(1e-12));
          idyn[dd] = T(1) / xmax(ddyn[dd], T(1e-12));
        }
      }
      T ft[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      const int b = dof_body[dd];
      for (int i = desc_off[b]; i < desc_off[b + 1]; ++i)
        for (int j = 0; j < 6; ++j) ft[j] += sm[L.fb + 6 * desc_idx[i] + j];
      bias[dd] = dot6(s + 6 * dd, ft);
      // the dense branch's PD rhs, the PD column's first value
      if constexpr (DENSE) sm[L.xpd + dd] = pd_terms(qfb_d, e_d);
    }
    __syncthreads();
    STAMP(ST_DYNAMICS);

    if constexpr (DENSE) {
      // ================= the dense branch: one substep on this prep ======
#ifdef EGOPOSE_POISON
      if (d.poison) {
        // every value but those of the arrays live into the factors (q, v,
        // J^T, tgt, mu, the square, the PD column) is NaN from here: the
        // dead prep, and what the later stages write before they read it
        for (int e = tid; e < d.l_total; e += NT)
          if (!in_span(e, L.q, nq) && !in_span(e, L.v, nd) &&
              !in_span(e, L.jt, nd * c3) && !in_span(e, L.tgt, c3) &&
              !in_span(e, L.mu, k) && !in_span(e, L.asq, nd * d.lda) &&
              !in_span(e, L.xpd, nd))
            sm[e] = T(NAN);
        __syncthreads();
      }
#endif
      T* asq = sm + L.asq;
      T* rpd = sm + L.rpd; T* rdyn = sm + L.rdyn;
      T* xpd = sm + L.xpd; T* xdyn = sm + L.xdyn; T* jq = sm + L.jq;
      const int lda = d.lda;
      const bool live = lane < c3 && ((amask >> lane) & 1u);
      // A_pd (upper triangle) on warp 0 with the PD column's forward half
      // riding on it; A_dyn (lower triangle) on warp 1 with Y = L^-1 J^T
      // riding on it, in place over J^T, and J v into jq
      if (warp == 0)
        warp_cholesky(asq, lda, rpd, nd, lane,
                      SubstRider<T>(xpd, 1, 0, 1, nd, lane, v, nullptr),
                      UpperShifted());
      else if (warp == 1)
        warp_cholesky(asq, lda, rdyn, nd, lane,
                      SubstRider<T>(JT, c3, 0, c3, nd, lane, v, jq, 0),
                      RowMajor());
      __syncthreads();
      STAMP(ST_FACTOR);
      // the PD column's back substitution on warp 0; beside it D = Y^T Y on
      // the active rows (lower triangle, mirrored) on warps 1-3
      if (warp == 0) {
        warp_ltsolve_vec(asq, lda, rpd, xpd, 1, nd, lane, UpperShifted());
      } else {
        for (int idx = tid - 32; idx < nact * nact; idx += NT - 32) {
          const int ai = idx / nact, bi = idx - ai * nact;
          if (bi > ai) continue;
          const int a = act[ai], b = act[bi];
          T p0 = T(0), p1 = T(0), p2 = T(0), p3 = T(0);
          int dd = 0;
          for (; dd + 4 <= nd; dd += 4) {
            p0 += JT[dd * c3 + a] * JT[dd * c3 + b];
            p1 += JT[(dd + 1) * c3 + a] * JT[(dd + 1) * c3 + b];
            p2 += JT[(dd + 2) * c3 + a] * JT[(dd + 2) * c3 + b];
            p3 += JT[(dd + 3) * c3 + a] * JT[(dd + 3) * c3 + b];
          }
          for (; dd < nd; ++dd) p0 += JT[dd * c3 + a] * JT[dd * c3 + b];
          const T g = (p0 + p1) + (p2 + p3);
          G[a * c3 + b] = g;
          G[b * c3 + a] = g;
        }
      }
      __syncthreads();
      STAMP(ST_GRAM);
      // torque, clamp and dt qfrc (the dof owners); the sweep's row scale
      // relax / (sum_b |D_ab| + 1e-9) beside them
      if (owner) {
        T qf = qfb_d;
        if (hinge) {
          T tq = -kp_r * e_d - kd_r * (v[tid] + dt * xpd[tid]);
          tq = xmin(xmax(tq, -tlim_r), tlim_r);
          qf += tq * gear_r;
        }
        xdyn[tid] = qf * dt;
      }
      for (int ai = tid - 64; ai >= 0 && ai < nact; ai += NT - 64) {
        const int a = act[ai];
        T acc = T(0);
        for (int bi = 0; bi < nact; ++bi) acc += xabs(G[act[bi] * c3 + a]);
        gid[a] = relax / (acc + T(1e-9));
      }
      __syncthreads();
      STAMP(ST_TORQUE);
      // warp 0 from here: z0 = L^-1 (dt qfrc) ...
      if (warp == 0) warp_lsolve_vec(asq, lda, rdyn, xdyn, 1, nd, lane);
      STAMP(ST_Z0);
      // ... the residual J v + Y^T z0 - target ...
      T bh_r = T(0);
      if (warp == 0 && live)
        bh_r = lane_residual(JT, xdyn, tgt, c3, nd, lane) + jq[lane];
      STAMP(ST_RESIDUAL);
      // ... the sweep ...
      if (warp == 0)
        warp_sweep(G, gid, lam, mu, act, nact, live, bh_r, k, c3, d.iters,
                   lane);
      STAMP(ST_SWEEP);
      // ... and v_new = v + L^-T (z0 + Y lam)
      if (warp == 0) {
        for (int i = lane; i < nd; i += 32) {
          T acc = T(0);
          for (int ci = 0; ci < nact; ++ci) {
            const int c = act[ci];
            acc += JT[i * c3 + c] * lam[c];
          }
          xdyn[i] += acc;
        }
        __syncwarp();
        warp_ltsolve_vec(asq, lda, rdyn, xdyn, 1, nd, lane);
        for (int i = lane; i < nd; i += 32) xdyn[i] += v[i];
      }
      __syncthreads();
      STAMP(ST_VELOCITY);
      integrate(xdyn);
      __syncthreads();
      STAMP(ST_INTEGRATE);
    } else {
      // ---- tree LDL^T of both systems, by levels -------------------------
      block_factor(mpd, mdyn, dpd, ddyn, ipd, idyn, itab + d.i_fac_a,
                   itab + d.i_fac_b, itab + d.i_fac_row, d.n_fac, nnz, tid);
      STAMP(ST_FACTOR);

      // ---- L^-1 of both factors in L's slots, one row per thread, from
      // L^-1 L = I: Linv[k][s] = -(L[k][s] + sum_{s<t<depth k} Linv[k][t]
      // L[anc[k][t]][s]) for s = depth k - 1 down to 0 (slot s of row
      // anc[k][t] is ancestor anc[k][s]: the lists nest).  A row needs only
      // itself and L, so all rows run at once.  abase[e] = anc_off[anc_idx[e]]
      // is staged in shared memory (ints in a prep-only span).
      int* abase = reinterpret_cast<int*>(sm + L.abase);
      for (int e = tid; e < nnz; e += NT) abase[e] = itab[d.i_anc_base + e];
      __syncthreads();
      for (int idx = tid; idx < 2 * nd; idx += NT) {
        const bool dyn = idx >= nd;
        const int kk = dyn ? idx - nd : idx;
        const T* Lr = dyn ? mdyn : mpd;
        T* Li = dyn ? lidyn : lipd;
        const int base = anc_off[kk], dl = anc_off[kk + 1] - base;
        for (int sl = dl - 1; sl >= 0; --sl) {
          T p0 = Lr[base + sl], p1 = T(0), p2 = T(0), p3 = T(0);
          int t = sl + 1;
          for (; t + 4 <= dl; t += 4) {
            p0 += Li[base + t] * Lr[abase[base + t] + sl];
            p1 += Li[base + t + 1] * Lr[abase[base + t + 1] + sl];
            p2 += Li[base + t + 2] * Lr[abase[base + t + 2] + sl];
            p3 += Li[base + t + 3] * Lr[abase[base + t + 3] + sl];
          }
          for (; t < dl; ++t) p0 += Li[base + t] * Lr[abase[base + t] + sl];
          Li[base + sl] = -((p0 + p1) + (p2 + p3));
        }
      }
      __syncthreads();
      for (int e = tid; e < nnz; e += NT) mpd[e] = lipd[e];   // L_pd^-1
      __syncthreads();
      STAMP(ST_INVERSE);

      // ---- Y = L^-T J^T = (L_dyn^-1)^T J^T on the active columns: one
      // gather over a column of L^-1 per (dof, column), from a copy of J^T
      T* jt = sm + L.jt;
      for (int e = tid; e < nd * c3; e += NT) jt[e] = Y[e];
      __syncthreads();
      for (int idx = tid; idx < nd * nact; idx += NT) {
        const int j = idx / nact, c = act[idx % nact];
        const int i0 = col_off[j], m = col_off[j + 1] - i0;
        T p0 = jt[j * c3 + c], p1 = T(0), p2 = T(0), p3 = T(0);
        int i = i0;
        for (; i + 4 <= i0 + m; i += 4) {
          p0 += lidyn[__ldg(col_slot + i)] * jt[__ldg(col_row + i) * c3 + c];
          p1 += lidyn[__ldg(col_slot + i + 1)] * jt[__ldg(col_row + i + 1) * c3 + c];
          p2 += lidyn[__ldg(col_slot + i + 2)] * jt[__ldg(col_row + i + 2) * c3 + c];
          p3 += lidyn[__ldg(col_slot + i + 3)] * jt[__ldg(col_row + i + 3) * c3 + c];
        }
        for (; i < i0 + m; ++i)
          p0 += lidyn[__ldg(col_slot + i)] * jt[__ldg(col_row + i) * c3 + c];
        Y[j * c3 + c] = (p0 + p1) + (p2 + p3);
      }
      __syncthreads();
      STAMP(ST_Y);
      // ---- Delassus G = Y^T D^-1 Y on the active rows + row-sum scale ----
      for (int idx = tid; idx < nact * nact; idx += NT) {
        const int ai = idx / nact, bi = idx % nact;
        if (bi > ai) continue;
        const int a = act[ai], b = act[bi];
        T acc = T(0);
        for (int dd = 0; dd < nd; ++dd)
          acc += (idyn[dd] * Y[dd * c3 + a]) * Y[dd * c3 + b];
        G[a * c3 + b] = acc;
        G[b * c3 + a] = acc;
      }
      __syncthreads();
      for (int ai = tid; ai < nact; ai += NT) {
        const int a = act[ai];
        T acc = T(0);
        for (int bi = 0; bi < nact; ++bi) acc += xabs(G[a * c3 + act[bi]]);
        gid[a] = relax / (acc + T(1e-9));
      }
      __syncthreads();
      STAMP(ST_DELASSUS);

      // ================= substeps against the frozen prep ================
      const bool live = lane < c3 && ((amask >> lane) & 1u);
      for (int sub = 0; sub < nsub; ++sub) {
        // joint limits, passive forces, stable-PD error and rhs; w = L v
        T qfb_r = T(0), e_r = T(0);
        if (owner) rhs[tid] = pd_terms(qfb_r, e_r);
        // w = L_dyn v on the warps that own no dof (threads 64.. for nd <= 64)
        for (int dd = tid - 64; dd >= 0 && dd < nd; dd += NT - 64)
          w[dd] = v[dd] + gather_dot(mdyn, v, (const int*)nullptr, anc_idx,
                                     anc_off[dd], anc_off[dd + 1] - anc_off[dd]);
        __syncthreads();
        // PD solve, each dof a gather over L_pd^-1: z = D^-1 L^-T rhs, then
        // qacc = L^-1 z; the clamped torque -> dynamics rhs (times dt) in rhs
        if (owner)
          z[tid] = ipd[tid] * (rhs[tid] + gather_dot(mpd, rhs, col_slot, col_row,
                                                     col_off[tid], col_off[tid + 1] - col_off[tid]));
        __syncthreads();
        T qacc = T(0);
        if (owner)
          qacc = z[tid] + gather_dot(mpd, z, (const int*)nullptr, anc_idx, anc_off[tid],
                                     anc_off[tid + 1] - anc_off[tid]);
        STAMP(ST_PD);
        if (owner) {
          T qf = qfb_r;
          if (hinge) {
            T tq = -kp_r * e_r - kd_r * (v[tid] + dt * qacc);
            tq = xmin(xmax(tq, -tlim_r), tlim_r);
            qf += tq * gear_r;
          }
          rhs[tid] = qf * dt;
        }
        __syncthreads();
        STAMP(ST_TORQUE);
        // u = D^-1 L^-T (dt qfrc) over L_dyn^-1's columns
        if (owner) {
          u[tid] = idyn[tid] * (rhs[tid] + gather_dot(lidyn, rhs, col_slot, col_row,
                                                      col_off[tid], col_off[tid + 1] - col_off[tid]));
          w[tid] += u[tid];          // L v + u, the residual's vector
        }
        __syncthreads();
        STAMP(ST_DYN_SOLVE);
        // contact residual J v_pred - target = Y^T (L v + u) - target
        T bh_r = T(0);
        if (warp == 0 && live) bh_r = lane_residual(Y, w, tgt, c3, nd, lane);
        STAMP(ST_RESIDUAL);
        // projected-Jacobi sweep, one lane per contact row, G read by column
        if (warp == 0)
          warp_sweep(G, gid, lam, mu, act, nact, live, bh_r, k, c3, d.iters, lane);
        __syncthreads();
        STAMP(ST_SWEEP);
        // v_new = v + L^-1 D^-1 (z' + Y lam), z' = L^-T (dt qfrc): u += D^-1 Y lam,
        // then a gather over L_dyn^-1's row into z
        if (owner) {
          T acc = T(0);
          for (int ci = 0; ci < nact; ++ci) {
            const int c = act[ci];
            acc += Y[tid * c3 + c] * lam[c];
          }
          u[tid] += idyn[tid] * acc;
        }
        __syncthreads();
        if (owner)
          z[tid] = v[tid] + u[tid] + gather_dot(lidyn, u, (const int*)nullptr, anc_idx,
                                                anc_off[tid], anc_off[tid + 1] - anc_off[tid]);
        __syncthreads();
        STAMP(ST_VELOCITY);
        integrate(z);
        __syncthreads();
        STAMP(ST_INTEGRATE);
      }
    }
  }

  for (int i = tid; i < nq; i += NT) qpos_out[(size_t)env * nq + i] = q[i];
  if (owner) qvel_out[(size_t)env * nd + tid] = v[tid];
#ifdef EGOPOSE_STAGE_CLOCKS
  STAMP(ST_STORE);
  if (tid == 0)
    for (int i = 0; i < N_STAGES; ++i) clocks[(size_t)env * N_STAGES + i] = clk[i];
#endif
}

#define KERNEL_ARGS(T)                                                       \
  const Dims d, const int* __restrict__ itab, const T* __restrict__ ftab,    \
      const T* __restrict__ qpos, const T* __restrict__ qvel,                \
      const T* __restrict__ ctrl, const T* __restrict__ jkp,                 \
      const T* __restrict__ jkd, const T* __restrict__ tlim,                 \
      T* __restrict__ qpos_out, T* __restrict__ qvel_out,                    \
      long long* __restrict__ clocks
#define BODY_ARGS \
  d, itab, ftab, qpos, qvel, ctrl, jkp, jkd, tlim, qpos_out, qvel_out, clocks

// Sparse, float: at most 64 registers a thread, so 8 blocks of 128 fit an
// SM's 65,536; double: 4 blocks (its 47 KB block allows 4 per SM anyway).
__global__ void __launch_bounds__(NT, 8) substep_kernel(KERNEL_ARGS(float)) {
  substep_body<float, false>(BODY_ARGS);
}
__global__ void __launch_bounds__(NT, 4) substep_kernel(KERNEL_ARGS(double)) {
  substep_body<double, false>(BODY_ARGS);
}
// Dense: its 24.0 KB float block allows 9 per SM, so the registers
// decide: 8 blocks at 64 a thread, one wave at B = 1024; its 47 KB double
// block allows 4.
__global__ void __launch_bounds__(NT, 8)
substep_dense_kernel(KERNEL_ARGS(float)) {
  substep_body<float, true>(BODY_ARGS);
}
__global__ void __launch_bounds__(NT, 4)
substep_dense_kernel(KERNEL_ARGS(double)) {
  substep_body<double, true>(BODY_ARGS);
}

template <typename T>
using KernelFn = void (*)(const Dims, const int*, const T*, const T*,
                          const T*, const T*, const T*, const T*, const T*,
                          T*, T*, long long*);

// The branch's kernel: Dims.dense picks it.
template <typename T>
static KernelFn<T> kernel_of(const Dims& d) {
  return d.dense ? static_cast<KernelFn<T>>(substep_dense_kernel)
                 : static_cast<KernelFn<T>>(substep_kernel);
}

// Opt the kernel in to the block's shared memory; 0, -1 (dims mismatch),
// -2 (more than a block may use) or a CUDA error code.
template <typename T>
static int prepare(const int* dims_host, int ndims, Dims* d, size_t* bytes) {
  if (ndims * (int)sizeof(int) != (int)sizeof(Dims)) return -1;
  memcpy(d, dims_host, sizeof(Dims));
  *bytes = smem_bytes<T>(*d);
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*bytes > (size_t)max_optin) return -2;
  return (int)cudaFuncSetAttribute(kernel_of<T>(*d),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*bytes);
}

template <typename T>
static int launch(const int* dims_host, int ndims, const int* itab,
                  const T* ftab, const T* qpos, const T* qvel, const T* ctrl,
                  const T* jkp, const T* jkd, const T* tlim, T* qpos_out,
                  T* qvel_out, long long* clocks, int batch, void* stream) {
  Dims d;
  size_t bytes = 0;
  const int err = prepare<T>(dims_host, ndims, &d, &bytes);
  if (err != 0) return err;
  const KernelFn<T> kernel = kernel_of<T>(d);
  kernel<<<batch, NT, bytes, (cudaStream_t)stream>>>(
      d, itab, ftab, qpos, qvel, ctrl, jkp, jkd, tlim, qpos_out, qvel_out,
      clocks);
  return (int)cudaGetLastError();
}

extern "C" int egopose_substep_f32(
    const int* dims, int ndims, const void* itab, const void* ftab,
    const void* qpos, const void* qvel, const void* ctrl, const void* jkp,
    const void* jkd, const void* tlim, void* qpos_out, void* qvel_out,
    int batch, void* stream) {
  typedef float T;
  return launch<T>(dims, ndims, (const int*)itab, (const T*)ftab,
                   (const T*)qpos, (const T*)qvel, (const T*)ctrl,
                   (const T*)jkp, (const T*)jkd, (const T*)tlim,
                   (T*)qpos_out, (T*)qvel_out, nullptr, batch, stream);
}

extern "C" int egopose_substep_f64(
    const int* dims, int ndims, const void* itab, const void* ftab,
    const void* qpos, const void* qvel, const void* ctrl, const void* jkp,
    const void* jkd, const void* tlim, void* qpos_out, void* qvel_out,
    int batch, void* stream) {
  typedef double T;
  return launch<T>(dims, ndims, (const int*)itab, (const T*)ftab,
                   (const T*)qpos, (const T*)qvel, (const T*)ctrl,
                   (const T*)jkp, (const T*)jkd, (const T*)tlim,
                   (T*)qpos_out, (T*)qvel_out, nullptr, batch, stream);
}

// Resources of the branch's kernel for dtype (0 float, 1 double) at these
// dims:
// out[0] blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// out[1] registers per thread, out[2] dynamic shared bytes per block,
// out[3] local (spill) bytes per thread.
template <typename T>
static int occupancy(const int* dims_host, int ndims, int* out) {
  Dims d;
  size_t bytes = 0;
  int err = prepare<T>(dims_host, ndims, &d, &bytes);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel_of<T>(d));
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel_of<T>(d),
                                                    NT, bytes);
  out[1] = attr.numRegs;
  out[2] = (int)bytes;
  out[3] = (int)attr.localSizeBytes;
  return (int)e;
}

extern "C" int egopose_substep_occupancy(const int* dims, int ndims, int f64,
                                         int* out) {
  return f64 ? occupancy<double>(dims, ndims, out)
             : occupancy<float>(dims, ndims, out);
}

#ifdef EGOPOSE_STAGE_CLOCKS
extern "C" int egopose_substep_clocks_f32(
    const int* dims, int ndims, const void* itab, const void* ftab,
    const void* qpos, const void* qvel, const void* ctrl, const void* jkp,
    const void* jkd, const void* tlim, void* qpos_out, void* qvel_out,
    void* clocks, int batch, void* stream) {
  typedef float T;
  return launch<T>(dims, ndims, (const int*)itab, (const T*)ftab,
                   (const T*)qpos, (const T*)qvel, (const T*)ctrl,
                   (const T*)jkp, (const T*)jkd, (const T*)tlim,
                   (T*)qpos_out, (T*)qvel_out, (long long*)clocks, batch,
                   stream);
}
#endif
