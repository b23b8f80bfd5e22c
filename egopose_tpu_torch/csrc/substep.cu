// Substep-resident stable-PD control step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel egopose_tpu/physics/substep_pallas.py::
// _substep_kernel (launched by _substep_tpu through make_substep_step).  One
// launch runs one whole 30 Hz control step -- n_frames substeps grouped by
// the prep-refresh cadence R, the remainder group last -- for a batch of
// environments:
//
//   per group: FK -> CRBA in compressed ancestor-slot rows -> RNEA bias ->
//              floor top-K and capsule/box pair narrowphase with top-KP
//              selection -> contact Jacobian -> sparse tree LDL^T of the PD
//              and dynamics systems -> Y = L^-T J^T -> Delassus Y^T D^-1 Y
//   per substep: joint limits + PD rhs -> PD solve -> torque clamp ->
//              dynamics solve -> projected-Jacobi sweep -> L^-1 D^-1 (Y lam)
//              -> semi-implicit integration
//
// Design.  One thread block per environment, 128 threads, the lane's whole
// working set in (dynamic) shared memory: 39.4 KB in float and 78.8 KB in
// double for the 58-dof humanoid.  Device memory is touched for the state,
// controls and gains in and the state out, once per control step, plus the
// read-only model tables (a few tens of KB shared by all blocks, L1/L2
// resident).  Threads work over bodies within an FK level, over dofs for
// CRBA / bias / PD rhs / integration, over pairs for the narrowphase, and
// over contact rows for the Jacobian and Delassus; __syncthreads separates
// the stages.  The tree factorization runs leaves first, one dof at a time,
// parallel over the dof's ancestor slots (both systems in the same pass);
// the single-column solves and the 10-iteration sweep (<= 32 rows) run in
// one warp with __syncwarp and shuffles.
//
// What bounds it.  Per environment the work is a long chain of small
// dependent stages (~60 factor steps, ~3 x 58 solve steps and 10 sweep
// iterations per substep), so a block is latency-bound on that chain, not
// on bytes or flops: the bytes per control step are ~2 KB per environment
// and the flops ~1-2 MFLOP.  The design answers with many independent blocks
// in flight (several per SM) rather than with wide per-block parallelism.
//
// The model is not baked into the code: every table arrives as device
// memory (itab: int32, ftab: T) described by the Dims offsets, which the
// Python wrapper (physics/substep.py) builds once per model.  No
// --use_fast_math: the 58-dof system is stiff.
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#define NT 128

struct Dims {
  int nb, nd, nq, nu, ncp, npair, nbpair, k, kp, c3, nnz, nlevel;
  int n_frames, prep_refresh, iters;
  int i_parent, i_dof_body, i_hinge0, i_nhinge, i_lvl_off, i_lvl_body;
  int i_path_off, i_path_idx, i_vp_off, i_vp_idx, i_desc_off, i_desc_idx;
  int i_anc_off, i_anc_idx, i_ent_row, i_banc, i_cp_body;
  int i_p_b1, i_p_b2, i_bp_seg, i_bp_box;
  int f_body_pos, f_body_ipos, f_mass, f_inertia, f_axis, f_anchor;
  int f_armature, f_damping, f_stiffness, f_lo, f_hi, f_limited, f_gear;
  int f_gravity, f_cp_local, f_cp_radius, f_cp_mu;
  int f_p_a1, f_p_b1, f_p_a2, f_p_b2, f_p_rsum, f_p_rdiff;
  int f_bp_a, f_bp_b, f_bp_rseg, f_bp_pos, f_bp_quat, f_bp_half, f_scal;
};

// Offsets (in elements of T) of every shared-memory array of one block.
struct Layout {
  int q, v, ctrl, kp, kd, tlim;
  int xpos, xquat, com, ic, io, smom, sio, smass, s, fcrb;
  int mpd, mdyn, dpd, ddyn, ipd, idyn, bias;
  int sq, cj, fb;
  int pall, phiall, pphi, pn, pp;
  int jf, y, g, gid, tgt, bh, mu, selphi;
  int qfb, e, rhs, x0, u, vn, lam;
  int total;  // T elements; the (k + kp) selected indices (int) follow
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  int o = 0;
  auto take = [&o](int n) { int r = o; o += n; return r; };
  const int pp = d.npair + d.nbpair;
  L.q = take(d.nq); L.v = take(d.nd); L.ctrl = take(d.nu);
  L.kp = take(d.nd); L.kd = take(d.nd); L.tlim = take(d.nu);
  L.xpos = take(3 * d.nb); L.xquat = take(4 * d.nb); L.com = take(3 * d.nb);
  L.ic = take(6 * d.nb); L.io = take(6 * d.nb);
  L.smom = take(3 * d.nb); L.sio = take(6 * d.nb); L.smass = take(d.nb);
  L.s = take(6 * d.nd); L.fcrb = take(6 * d.nd);
  L.mpd = take(d.nnz); L.mdyn = take(d.nnz);
  L.dpd = take(d.nd); L.ddyn = take(d.nd); L.ipd = take(d.nd);
  L.idyn = take(d.nd); L.bias = take(d.nd);
  L.sq = take(6 * d.nd); L.cj = take(6 * d.nd);
  L.fb = take(6 * d.nb);
  L.pall = take(3 * d.ncp); L.phiall = take(d.ncp);
  L.pphi = take(pp); L.pn = take(3 * pp); L.pp = take(3 * pp);
  L.jf = take(d.c3 * d.nd); L.y = take(d.nd * d.c3); L.g = take(d.c3 * d.c3);
  L.gid = take(d.c3); L.tgt = take(d.c3); L.bh = take(d.c3); L.mu = take(d.k);
  L.selphi = take(d.k + d.kp);
  L.qfb = take(d.nd); L.e = take(d.nd); L.rhs = take(d.nd);
  L.x0 = take(d.nd); L.u = take(d.nd); L.vn = take(d.nd);
  L.lam = take(d.c3);
  L.total = o;
  return L;
}

// ---------------------------------------------------------------------------
// math for float and double (explicit, so the float build never promotes)
// ---------------------------------------------------------------------------

__device__ inline float xsqrt(float x) { return sqrtf(x); }
__device__ inline double xsqrt(double x) { return sqrt(x); }
__device__ inline float xsin(float x) { return sinf(x); }
__device__ inline double xsin(double x) { return sin(x); }
__device__ inline float xcos(float x) { return cosf(x); }
__device__ inline double xcos(double x) { return cos(x); }
__device__ inline float xabs(float x) { return fabsf(x); }
__device__ inline double xabs(double x) { return fabs(x); }
__device__ inline float xmax(float a, float b) { return fmaxf(a, b); }
__device__ inline double xmax(double a, double b) { return fmax(a, b); }
__device__ inline float xmin(float a, float b) { return fminf(a, b); }
__device__ inline double xmin(double a, double b) { return fmin(a, b); }

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

// Solve (L^T D L) x = b in place by one warp (ldl_pallas.ldl_solve): the
// leaves-first L^-T sweep, the diagonal scale, then the ancestor
// substitution.  ``rows`` holds L in compressed ancestor-slot rows.
template <typename T>
__device__ void warp_ldl_solve(const T* rows, const T* invd, T* x,
                               const int* anc_off, const int* anc_idx, int nd,
                               int lane) {
  for (int k = nd - 1; k >= 0; --k) {
    const int base = anc_off[k], dk = anc_off[k + 1] - base;
    const T xk = x[k];
    for (int s = lane; s < dk; s += 32) x[anc_idx[base + s]] -= rows[base + s] * xk;
    __syncwarp();
  }
  for (int k = lane; k < nd; k += 32) x[k] *= invd[k];
  __syncwarp();
  for (int k = 0; k < nd; ++k) {
    const int base = anc_off[k], dk = anc_off[k + 1] - base;
    T acc = T(0);
    for (int s = lane; s < dk; s += 32) acc += rows[base + s] * x[anc_idx[base + s]];
    acc = warp_sum(acc);
    if (lane == 0) x[k] -= acc;
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
substep_kernel(const Dims d, const int* __restrict__ itab,
               const T* __restrict__ ftab, const T* __restrict__ qpos,
               const T* __restrict__ qvel, const T* __restrict__ ctrl,
               const T* __restrict__ jkp, const T* __restrict__ jkd,
               const T* __restrict__ tlim, T* __restrict__ qpos_out,
               T* __restrict__ qvel_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Layout L = make_layout(d);
  int* sel = reinterpret_cast<int*>(sm + L.total);  // k floor, kp pair idx

  const int env = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nb = d.nb, nd = d.nd, nq = d.nq, nu = d.nu, k = d.k, kp = d.kp;
  const int c3 = d.c3, pp = d.npair + d.nbpair;

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
  T* kpf = sm + L.kp;  T* kdf = sm + L.kd;
  T* xpos = sm + L.xpos; T* xquat = sm + L.xquat; T* com = sm + L.com;
  T* ic = sm + L.ic; T* io = sm + L.io;
  T* s = sm + L.s;     T* fcrb = sm + L.fcrb;
  T* mpd = sm + L.mpd; T* mdyn = sm + L.mdyn;
  T* dpd = sm + L.dpd; T* ddyn = sm + L.ddyn;
  T* ipd = sm + L.ipd; T* idyn = sm + L.idyn; T* bias = sm + L.bias;
  T* jf = sm + L.jf;   T* Y = sm + L.y;       T* G = sm + L.g;
  T* gid = sm + L.gid; T* tgt = sm + L.tgt;   T* mu = sm + L.mu;
  T* lam = sm + L.lam;

  // ---- load the lane's state, controls and gains -------------------------
  for (int i = tid; i < nq; i += NT) q[i] = qpos[(size_t)env * nq + i];
  for (int i = tid; i < nd; i += NT) {
    v[i] = qvel[(size_t)env * nd + i];
    kpf[i] = i < 6 ? T(0) : jkp[(size_t)env * nu + i - 6];
    kdf[i] = i < 6 ? T(0) : jkd[(size_t)env * nu + i - 6];
  }
  for (int i = tid; i < nu; i += NT) {
    sm[L.ctrl + i] = ctrl[(size_t)env * nu + i];
    sm[L.tlim + i] = tlim[(size_t)env * nu + i];
  }
  __syncthreads();

  const int R = d.prep_refresh;
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

    // ---- compressed mass matrix, bias, top-K selections ----------------
    for (int e = tid; e < d.nnz; e += NT) {
      const T val = dot6(fcrb + 6 * ent_row[e], s + 6 * anc_idx[e]);
      mpd[e] = val;
      mdyn[e] = val;
    }
    for (int dd = tid; dd < nd; dd += NT) {
      const T dg = dot6(fcrb + 6 * dd, s + 6 * dd) + ftab[d.f_armature + dd];
      dpd[dd] = dg + dt * kdf[dd];
      ddyn[dd] = dg + dt * ftab[d.f_damping + dd];
      T ft[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      const int b = dof_body[dd];
      for (int i = desc_off[b]; i < desc_off[b + 1]; ++i)
        for (int j = 0; j < 6; ++j) ft[j] += sm[L.fb + 6 * desc_idx[i] + j];
      bias[dd] = dot6(s + 6 * dd, ft);
    }
    if (warp == 0) warp_topk(sm + L.phiall, d.ncp, k, sel, sm + L.selphi, lane);
    if (warp == 1 && kp > 0)
      warp_topk(sm + L.pphi, pp, kp, sel + k, sm + L.selphi + k, lane);
    __syncthreads();

    // ---- contact Jacobian rows, targets, friction (engine.contact_blocks)
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
        const T act = sm[L.selphi + kk] > -margin ? T(1) : T(0);
        const T msk = banc[cp_body[pt] * nb + bd] ? T(1) : T(0);
        val = (sd[3 + comp] + cr[comp]) * (act * msk);
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
        const T act = sm[L.selphi + k + j] > -margin ? T(1) : T(0);
        const T row = (sd[3] * n[0] + sd[4] * n[1] + sd[5] * n[2])
                      + (sd[0] * pxn[0] + sd[1] * pxn[1] + sd[2] * pxn[2]);
        val = row * (act * sgn);
      }
      jf[r * nd + dd] = val;
      Y[dd * c3 + r] = val;              // L^-T sweep input (J^T)
    }
    for (int r = tid; r < c3; r += NT) {
      T tg = T(0);
      if (r >= 2 * k) {
        const T ph = sm[L.selphi + r - 2 * k];   // floor normals, then pairs
        const T act = ph > -margin ? T(1) : T(0);
        tg = xmin(beta * xmax(ph - slop, T(0)) / dt, T(1)) * act;
      }
      tgt[r] = tg;
      if (r < k) mu[r] = ftab[d.f_cp_mu + sel[r]];
    }
    __syncthreads();

    // ---- sparse tree LDL^T of both systems (ldl_pallas.ldl_factor) -----
    for (int kk = nd - 1; kk >= 0; --kk) {
      const int base = anc_off[kk], dk = anc_off[kk + 1] - base;
      for (int idx = tid; idx < 2 * dk; idx += NT) {
        const bool dyn = idx >= dk;
        const int sl = dyn ? idx - dk : idx;
        T* M = dyn ? mdyn : mpd;
        T* D = dyn ? ddyn : dpd;
        const T inv = T(1) / xmax(D[kk], T(1e-12));
        const T row_s = M[base + sl];
        const T tmp_s = row_s * inv;
        const int j = anc_idx[base + sl];
        D[j] -= tmp_s * row_s;
        const int jb = anc_off[j];       // anc[j] == anc[kk][:sl]
        for (int t = 0; t < sl; ++t) M[jb + t] -= tmp_s * M[base + t];
      }
      __syncthreads();
      // scale row kk to L's row; iteration kk-1 touches rows < kk only
      for (int idx = tid; idx < 2 * dk + 2; idx += NT) {
        const bool dyn = idx >= dk + 1;
        const int sl = dyn ? idx - dk - 1 : idx;
        const T inv = T(1) / xmax(dyn ? ddyn[kk] : dpd[kk], T(1e-12));
        if (sl == dk) (dyn ? idyn : ipd)[kk] = inv;
        else (dyn ? mdyn : mpd)[base + sl] *= inv;
      }
    }
    __syncthreads();

    // ---- Y = L^-T J^T (one thread per contact column) ------------------
    for (int c = tid; c < c3; c += NT) {
      for (int kk = nd - 1; kk >= 0; --kk) {
        const T yk = Y[kk * c3 + c];
        if (yk == T(0)) continue;
        for (int i = anc_off[kk]; i < anc_off[kk + 1]; ++i)
          Y[anc_idx[i] * c3 + c] -= mdyn[i] * yk;
      }
    }
    __syncthreads();
    // ---- Delassus G = Y^T D^-1 Y (symmetric) + row-sum preconditioner --
    for (int idx = tid; idx < c3 * c3; idx += NT) {
      const int a = idx / c3, b = idx % c3;
      if (b > a) continue;
      T acc = T(0);
      for (int dd = 0; dd < nd; ++dd)
        acc += (idyn[dd] * Y[dd * c3 + a]) * Y[dd * c3 + b];
      G[a * c3 + b] = acc;
      G[b * c3 + a] = acc;
    }
    __syncthreads();
    for (int a = tid; a < c3; a += NT) {
      T acc = T(0);
      for (int b = 0; b < c3; ++b) acc += xabs(G[a * c3 + b]);
      gid[a] = relax / (acc + T(1e-9));
    }
    __syncthreads();

    // ================= substeps against the frozen prep ==================
    for (int sub = 0; sub < nsub; ++sub) {
      // joint limits, passive forces, stable-PD error and rhs
      for (int dd = tid; dd < nd; dd += NT) {
        T qfb = -bias[dd] - ftab[d.f_damping + dd] * v[dd];
        T e = T(0);
        if (dd >= 6) {
          const int j = dd - 6;
          const T qj = q[dd + 1], dqj = v[dd];
          const T below = xmax(ftab[d.f_lo + j] - qj, T(0));
          const T above = xmax(qj - ftab[d.f_hi + j], T(0));
          const T viol = (below > T(0) || above > T(0)) ? T(1) : T(0);
          const T taul = (klim * (below - above) - viol * blim * dqj) * ftab[d.f_limited + j];
          qfb += taul - ftab[d.f_stiffness + dd] * qj;
          e = qj - sm[L.ctrl + j];
        }
        sm[L.qfb + dd] = qfb;
        sm[L.e + dd] = e;
        sm[L.rhs + dd] = -bias[dd] - kpf[dd] * e - kdf[dd] * v[dd];
      }
      __syncthreads();
      if (warp == 0) warp_ldl_solve(mpd, ipd, sm + L.rhs, anc_off, anc_idx, nd, lane);
      __syncthreads();
      // clamped PD torque -> dynamics rhs (times dt)
      for (int dd = tid; dd < nd; dd += NT) {
        T qf = sm[L.qfb + dd];
        if (dd >= 6) {
          const int j = dd - 6;
          T tq = -kpf[dd] * sm[L.e + dd] - kdf[dd] * (v[dd] + dt * sm[L.rhs + dd]);
          const T lim = sm[L.tlim + j];
          tq = xmin(xmax(tq, -lim), lim);
          qf += tq * ftab[d.f_gear + j];
        }
        sm[L.x0 + dd] = qf * dt;
      }
      __syncthreads();
      if (warp == 0) warp_ldl_solve(mdyn, idyn, sm + L.x0, anc_off, anc_idx, nd, lane);
      __syncthreads();
      // velocity residual of the contact rows at v_pred = v + qacc dt
      for (int r = tid; r < c3; r += NT) {
        T acc = T(0);
        for (int dd = 0; dd < nd; ++dd) acc += jf[r * nd + dd] * (v[dd] + sm[L.x0 + dd]);
        sm[L.bh + r] = acc - tgt[r];
      }
      __syncthreads();
      // projected-Jacobi sweep, one lane per contact row
      if (warp == 0) {
        const int r = lane;
        const bool live = r < c3;
        T lr = T(0);
        if (live) lam[r] = T(0);
        __syncwarp();
        const int src = r < k ? 2 * k + r : (r < 2 * k ? r + k : r);
        for (int it = 0; it < d.iters; ++it) {
          T g = T(0);
          if (live) {
            for (int j = 0; j < c3; ++j) g += G[r * c3 + j] * lam[j];
            g += sm[L.bh + r];
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
      __syncthreads();
      for (int dd = tid; dd < nd; dd += NT) {
        T acc = T(0);
        for (int c = 0; c < c3; ++c) acc += Y[dd * c3 + c] * lam[c];
        sm[L.u + dd] = acc;
      }
      __syncthreads();
      // L^-1 D^-1 (Y lam): the forward half of the solve only
      if (warp == 0) {
        T* x = sm + L.u;
        for (int kk = lane; kk < nd; kk += 32) x[kk] *= idyn[kk];
        __syncwarp();
        for (int kk = 0; kk < nd; ++kk) {
          const int base = anc_off[kk], dk = anc_off[kk + 1] - base;
          T acc = T(0);
          for (int sl = lane; sl < dk; sl += 32) acc += mdyn[base + sl] * x[anc_idx[base + sl]];
          acc = warp_sum(acc);
          if (lane == 0) x[kk] -= acc;
          __syncwarp();
        }
      }
      __syncthreads();
      for (int dd = tid; dd < nd; dd += NT)
        sm[L.vn + dd] = v[dd] + sm[L.x0 + dd] + sm[L.u + dd];
      __syncthreads();
      // semi-implicit integration (engine.integrate / quat_integrate)
      const T* vn = sm + L.vn;
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
      for (int dd = tid; dd < nd; dd += NT) {
        if (dd >= 6) q[dd + 1] += dt * vn[dd];
        v[dd] = vn[dd];
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < nq; i += NT) qpos_out[(size_t)env * nq + i] = q[i];
  for (int i = tid; i < nd; i += NT) qvel_out[(size_t)env * nd + i] = v[i];
}

template <typename T>
static int launch(const int* dims_host, int ndims, const int* itab,
                  const T* ftab, const T* qpos, const T* qvel, const T* ctrl,
                  const T* jkp, const T* jkd, const T* tlim, T* qpos_out,
                  T* qvel_out, int batch, void* stream) {
  if (ndims * (int)sizeof(int) != (int)sizeof(Dims)) return -1;
  Dims d;
  memcpy(&d, dims_host, sizeof(Dims));
  const Layout L = make_layout(d);
  const size_t bytes = (size_t)L.total * sizeof(T) + (size_t)(d.k + d.kp) * sizeof(int);
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)max_optin) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      substep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  substep_kernel<T><<<batch, NT, bytes, (cudaStream_t)stream>>>(
      d, itab, ftab, qpos, qvel, ctrl, jkp, jkd, tlim, qpos_out, qvel_out);
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
                   (T*)qpos_out, (T*)qvel_out, batch, stream);
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
                   (T*)qpos_out, (T*)qvel_out, batch, stream);
}
