// The LSTM's time loop for Hopper (sm_90a): K6, a forward, a backward and a
// tangent kernel.
//
// Replaces no Pallas kernel.  The JAX package runs an LSTM over time as
// lax.scan (egopose_tpu/models/rnn.py::RNN), which XLA compiles into one
// loop on the device; eager PyTorch paid ~8 launches a cell step, and as
// many again under autograd (models/rnn.py's loop: ~4,500 launches for a
// bi-LSTM pass and its backward over 70 frames).  These kernels run the
// recurrence alone.  Every large product stays a matmul outside
// (ops/lstm.py): the input projection xg = x W_ih^T + b_ih + b_hh of all
// steps before the forward kernel; dW_hh, dW_ih, the biases' and x's
// gradients from the backward kernel's gate gradients after it.
//
// Forward: per direction d and step t (walked from T-1 down where bit d of
// rev_mask is set), gates = xg[t] + h W_hh^T in the (i, f, g, o) order of
// torch.nn.LSTMCell, c = sig(f) c + sig(i) tanh(g), h = sig(o) tanh(c),
// from a zero carry.  Writes h into y (T, B, ndir H), the directions side
// by side, and, where autograd needs them (non-null pointers), the gate
// activations (T, B, ndir 4H) and c (T, B, ndir H).
// Backward: walks each direction the other way from dy (T, B, ndir H):
// dh = dy[t] + dg_{t+1} W_hh, dc = dc_{t+1} f_{t+1} + dh o (1 - tanh^2 c),
// and writes the pre-activation gate gradients dg (T, B, ndir 4H).
// Tangent (forward-mode autograd, torch.func.jvp): the forward's walk
// linearised at its gates and c, from the tangent of the pre-activation
// gates that does not pass through the carry, tg[t] = dxg[t] + h_{t-1}
// dW_hh^T (one matmul before the kernel): dz = tg[t] + dh W_hh^T, then
// dc = sig'(f) dz_f c_{t-1} + f dc + sig'(i) dz_i g + i tanh'(g) dz_g and
// dh = sig'(o) dz_o tanh(c) + o (1 - tanh^2 c) dc.  Writes dh (T, B,
// ndir H).  It is the forward kernel's product and carry with the tangent
// in place of the state.
//
// What bounds it.  A step is B x 4H x H multiply-adds a direction (34
// MFLOP at B 1024, H 64, both directions), T steps in order: at every
// size the cells run, the card's floor is microseconds a pass, and what
// costs is the chain of T dependent steps, each a product, a barrier and
// the gate arithmetic.  So the design keeps the chain on chip and short:
// - One block holds BT = RG x R batch rows of one direction for all T
//   steps, H x RG threads (RG = max(1, 256 / H), H at most 256): thread
//   (u, group) owns hidden unit u of R rows.  c (forward), dc (tangent)
//   and the dh and dc carries (backward) stay in its registers; the
//   block's h (forward), dh (tangent) or dg (backward) of the last step
//   sits in shared memory, double-
//   buffered, so a step ends in one __syncthreads and no block waits on
//   another.
// - W_hh is staged in shared memory once a launch, laid out so that a
//   warp's 32 units read 32 consecutive words (forward and tangent W_hh^T
//   (H, 4H), backward W_hh (4H, H)) while the rows' h, dh or dg are
//   broadcast.  Where it
//   does not fit beside the buffers (H 128 in float is 256 KB, above the
//   227 KB a block may have), every block reads it from global memory each
//   step, coalesced, and the 50 MB L2 holds it.  Splitting the gate rows
//   over a cluster would keep it on chip, at the price of a cluster
//   barrier and an exchange of h through distributed shared memory each
//   step; that pays where few blocks run, and the only H 128 nets (the
//   forecast's) run at B 1024 in the update, where many blocks share the
//   L2's bandwidth and each reuses a weight it reads for R rows.
// - The next step's inputs (xg; tg, the gates and c; or dy, the gates and
//   c) are loaded before
//   the step's product, so their latency hides behind it.
// - The launch picks R (1, 2, 4 or 8 rows a thread) from B, H, the
//   directions and the card (pick_rows): the most rows a thread that
//   still give every SM a block with W_hh in shared memory, or 8 where
//   W_hh does not fit there at all and is read from L2, so that each read
//   serves the most rows (at B 1024, H 128: 2.15 ms a forward pass at R 2,
//   where 256 blocks read 64 MB of L2 a step).
// No --use_fast_math: expf and tanhf as PyTorch's own.
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#define GROUP_THREADS 256   // the most threads of a block: H x RG
#define MAX_HID 256         // so a block of H x 1 threads still fits

__device__ inline float xexp(float x) { return expf(x); }
__device__ inline double xexp(double x) { return exp(x); }
__device__ inline float xtanh(float x) { return tanhf(x); }
__device__ inline double xtanh(double x) { return tanh(x); }

template <typename T>
__device__ inline T sigm(T x) { return T(1) / (T(1) + xexp(-x)); }

static inline int row_groups(int hid) {
  const int g = GROUP_THREADS / hid;
  return g < 1 ? 1 : g;
}

struct Shape {
  int steps, batch, hid, ndir, rev_mask, w_smem;
};

// Bytes of a block's double buffer (forward: h, tangent: dh, backward: dg)
// and of one direction's W_hh.
template <typename T>
static size_t buffer_bytes(int hid, int rows, bool bwd) {
  return 2 * (size_t)row_groups(hid) * rows * (bwd ? 4 * hid : hid)
         * sizeof(T);
}
template <typename T>
static size_t weight_bytes(int hid) {
  return (size_t)4 * hid * hid * sizeof(T);
}

// One direction's weight (n words at w) as the block reads it: staged in
// shared memory at ws where it fits (s.w_smem), else in global memory.
template <typename T>
__device__ __forceinline__ const T* stage_weight(const Shape& s, const T* w,
                                                 T* ws, int n) {
  if (!s.w_smem) return w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) ws[i] = w[i];
  return ws;
}

// The forward walk's product for R rows of unit u: acc[q][k] = sum_j
// v[q][j] W_hh^T[j][k H + u], v the block's R rows of h (or of its tangent)
// from the step before (hp, H apart) and w = W_hh^T (H, 4H) + u.
template <typename T, int R>
__device__ __forceinline__ void hh_product(T (&acc)[R][4], const T* hp,
                                           const T* w, int H) {
  const int G = 4 * H;
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[q][k] = T(0);
#pragma unroll 4
  for (int j = 0; j < H; ++j) {
    const T* wj = w + (size_t)j * G;
    const T w0 = wj[0], w1 = wj[H], w2 = wj[2 * H], w3 = wj[3 * H];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const T h = hp[q * H + j];
      acc[q][0] += h * w0;
      acc[q][1] += h * w1;
      acc[q][2] += h * w2;
      acc[q][3] += h * w3;
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(GROUP_THREADS)
lstm_fwd_kernel(const Shape s, const T* __restrict__ xg,
                const T* __restrict__ wt, T* __restrict__ y,
                T* __restrict__ gates, T* __restrict__ cst) {
  extern __shared__ __align__(16) unsigned char lstm_smem[];
  const int H = s.hid, G = 4 * H, d = blockIdx.y;
  const int u = threadIdx.x % H, r0 = (threadIdx.x / H) * R;
  const int bt = (blockDim.x / H) * R;
  const long long b0 = (long long)blockIdx.x * bt + r0;
  const bool rev = (s.rev_mask >> d) & 1;
  const size_t ys = (size_t)s.ndir * H, gs = (size_t)s.ndir * G;
  T* hs = reinterpret_cast<T*>(lstm_smem);          // [2][bt][H]
  const T* w = stage_weight(s, wt + (size_t)d * H * G, hs + 2 * bt * H,
                            H * G) + u;             // [H][G]
  for (int i = threadIdx.x; i < bt * H; i += blockDim.x) hs[i] = T(0);
  T c[R];
#pragma unroll
  for (int q = 0; q < R; ++q) c[q] = T(0);
  __syncthreads();

  for (int n = 0; n < s.steps; ++n) {
    const int t = rev ? s.steps - 1 - n : n;
    T xv[R][4], acc[R][4];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long b = b0 + q;
      const T* xp = xg + ((size_t)t * s.batch + b) * gs + d * G + u;
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[q][k] = b < s.batch ? xp[k * H] : T(0);
    }
    hh_product<T, R>(acc, hs + (n & 1) * bt * H + r0 * H, w, H);
    T* hn = hs + ((n + 1) & 1) * bt * H + r0 * H;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const T ig = sigm(xv[q][0] + acc[q][0]);
      const T fg = sigm(xv[q][1] + acc[q][1]);
      const T gg = xtanh(xv[q][2] + acc[q][2]);
      const T og = sigm(xv[q][3] + acc[q][3]);
      c[q] = fg * c[q] + ig * gg;
      const T h = og * xtanh(c[q]);
      hn[q * H + u] = h;
      const long long b = b0 + q;
      if (b < s.batch) {
        const size_t row = (size_t)t * s.batch + b;
        y[row * ys + d * H + u] = h;
        if (gates) {
          T* gp = gates + row * gs + d * G + u;
          gp[0] = ig; gp[H] = fg; gp[2 * H] = gg; gp[3 * H] = og;
        }
        if (cst) cst[row * ys + d * H + u] = c[q];
      }
    }
    __syncthreads();
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(GROUP_THREADS)
lstm_jvp_kernel(const Shape s, const T* __restrict__ tg,
                const T* __restrict__ wt, const T* __restrict__ gates,
                const T* __restrict__ cst, T* __restrict__ dy) {
  extern __shared__ __align__(16) unsigned char lstm_smem[];
  const int H = s.hid, G = 4 * H, d = blockIdx.y;
  const int u = threadIdx.x % H, r0 = (threadIdx.x / H) * R;
  const int bt = (blockDim.x / H) * R;
  const long long b0 = (long long)blockIdx.x * bt + r0;
  const bool rev = (s.rev_mask >> d) & 1;
  const size_t ys = (size_t)s.ndir * H, gs = (size_t)s.ndir * G;
  T* hs = reinterpret_cast<T*>(lstm_smem);          // [2][bt][H]: dh
  const T* w = stage_weight(s, wt + (size_t)d * H * G, hs + 2 * bt * H,
                            H * G) + u;             // [H][G]
  for (int i = threadIdx.x; i < bt * H; i += blockDim.x) hs[i] = T(0);
  T dc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) dc[q] = T(0);
  __syncthreads();

  for (int n = 0; n < s.steps; ++n) {
    const int t = rev ? s.steps - 1 - n : n;
    const int tp = rev ? t + 1 : t - 1;       // the walk's step before
    T zv[R][4], a[R][4], c[R], cp[R], acc[R][4];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long b = b0 + q;
      const bool ok = b < s.batch;
      const size_t row = (size_t)t * s.batch + b;
      const T* zp = tg + row * gs + d * G + u;
      const T* gp = gates + row * gs + d * G + u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        zv[q][k] = ok ? zp[k * H] : T(0);
        a[q][k] = ok ? gp[k * H] : T(0);
      }
      c[q] = ok ? cst[row * ys + d * H + u] : T(0);
      cp[q] = ok && n > 0
          ? cst[((size_t)tp * s.batch + b) * ys + d * H + u] : T(0);
    }
    hh_product<T, R>(acc, hs + (n & 1) * bt * H + r0 * H, w, H);
    T* hn = hs + ((n + 1) & 1) * bt * H + r0 * H;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const T ig = a[q][0], fg = a[q][1], gg = a[q][2], og = a[q][3];
      const T di = ig * (T(1) - ig) * (zv[q][0] + acc[q][0]);
      const T df = fg * (T(1) - fg) * (zv[q][1] + acc[q][1]);
      const T dgg = (T(1) - gg * gg) * (zv[q][2] + acc[q][2]);
      const T dog = og * (T(1) - og) * (zv[q][3] + acc[q][3]);
      dc[q] = df * cp[q] + fg * dc[q] + di * gg + ig * dgg;
      const T tc = xtanh(c[q]);
      const T dh = dog * tc + og * (T(1) - tc * tc) * dc[q];
      hn[q * H + u] = dh;
      const long long b = b0 + q;
      if (b < s.batch) dy[((size_t)t * s.batch + b) * ys + d * H + u] = dh;
    }
    __syncthreads();
  }
}

// One step's inputs of the backward walk for R rows of a unit.
template <typename T, int R>
struct BwdIn {
  T gi[R], gf[R], gg[R], go[R], c[R], cp[R], dy[R];
};

template <typename T, int R>
__device__ inline void load_bwd(BwdIn<T, R>& in, const Shape& s,
                                const T* __restrict__ dy,
                                const T* __restrict__ gates,
                                const T* __restrict__ cst, int n, bool rev,
                                long long b0, int d, int u) {
  const int H = s.hid, G = 4 * H;
  const int t = rev ? n : s.steps - 1 - n;
  const int tp = rev ? t + 1 : t - 1;        // the forward walk's step before
  const bool prev = n + 1 < s.steps;
  const size_t ys = (size_t)s.ndir * H, gs = (size_t)s.ndir * G;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const long long b = b0 + q;
    const bool ok = b < s.batch;
    const size_t row = (size_t)t * s.batch + b;
    const T* gp = gates + row * gs + d * G + u;
    in.gi[q] = ok ? gp[0] : T(0);
    in.gf[q] = ok ? gp[H] : T(0);
    in.gg[q] = ok ? gp[2 * H] : T(0);
    in.go[q] = ok ? gp[3 * H] : T(0);
    in.c[q] = ok ? cst[row * ys + d * H + u] : T(0);
    in.dy[q] = ok ? dy[row * ys + d * H + u] : T(0);
    in.cp[q] = ok && prev
        ? cst[((size_t)tp * s.batch + b) * ys + d * H + u] : T(0);
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(GROUP_THREADS)
lstm_bwd_kernel(const Shape s, const T* __restrict__ dy,
                const T* __restrict__ wh, const T* __restrict__ gates,
                const T* __restrict__ cst, T* __restrict__ dg) {
  extern __shared__ __align__(16) unsigned char lstm_smem[];
  const int H = s.hid, G = 4 * H, d = blockIdx.y;
  const int u = threadIdx.x % H, r0 = (threadIdx.x / H) * R;
  const int bt = (blockDim.x / H) * R;
  const long long b0 = (long long)blockIdx.x * bt + r0;
  const bool rev = (s.rev_mask >> d) & 1;
  const size_t gs = (size_t)s.ndir * G;
  T* ds = reinterpret_cast<T*>(lstm_smem);          // [2][bt][G]
  const T* w = stage_weight(s, wh + (size_t)d * G * H, ds + 2 * bt * G,
                            G * H);                 // [G][H]
  T dh[R], dc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) dh[q] = dc[q] = T(0);
  BwdIn<T, R> in;
  load_bwd<T, R>(in, s, dy, gates, cst, 0, rev, b0, d, u);
  __syncthreads();

  for (int n = 0; n < s.steps; ++n) {
    const int t = rev ? n : s.steps - 1 - n;
    T* dn = ds + (n & 1) * bt * G + r0 * G;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const T tc = xtanh(in.c[q]);
      const T dhv = in.dy[q] + dh[q];
      const T dcv = dc[q] + dhv * in.go[q] * (T(1) - tc * tc);
      const T ai = dcv * in.gg[q] * in.gi[q] * (T(1) - in.gi[q]);
      const T af = dcv * in.cp[q] * in.gf[q] * (T(1) - in.gf[q]);
      const T ag = dcv * in.gi[q] * (T(1) - in.gg[q] * in.gg[q]);
      const T ao = dhv * tc * in.go[q] * (T(1) - in.go[q]);
      dc[q] = dcv * in.gf[q];
      T* dq = dn + q * G + u;
      dq[0] = ai; dq[H] = af; dq[2 * H] = ag; dq[3 * H] = ao;
      const long long b = b0 + q;
      if (b < s.batch) {
        T* gp = dg + ((size_t)t * s.batch + b) * gs + d * G + u;
        gp[0] = ai; gp[H] = af; gp[2 * H] = ag; gp[3 * H] = ao;
      }
    }
    __syncthreads();
    if (n + 1 == s.steps) break;              // the zero carry needs no dh
    load_bwd<T, R>(in, s, dy, gates, cst, n + 1, rev, b0, d, u);
    // dh = dg W_hh: one partial sum a gate, so four chains run side by side
    T acc[R][4];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[q][k] = T(0);
#pragma unroll 4
    for (int j = 0; j < H; ++j) {
      const T* wj = w + (size_t)j * H + u;
      const T w0 = wj[0], w1 = wj[(size_t)H * H], w2 = wj[(size_t)2 * H * H],
              w3 = wj[(size_t)3 * H * H];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const T* dr = dn + q * G + j;
        acc[q][0] += dr[0] * w0;
        acc[q][1] += dr[H] * w1;
        acc[q][2] += dr[2 * H] * w2;
        acc[q][3] += dr[3 * H] * w3;
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q)
      dh[q] = (acc[q][0] + acc[q][1]) + (acc[q][2] + acc[q][3]);
  }
}

// ---------------------------------------------------------------------------
// host side: one decision of where W_hh lives and of R, then the launch
// ---------------------------------------------------------------------------

enum Kind { kFwd = 0, kBwd = 1, kJvp = 2 };

static int check(const Shape& s) {
  return (s.steps < 1 || s.batch < 1 || s.hid < 1 || s.hid > MAX_HID
          || s.ndir < 1 || s.ndir > 2) ? -1 : 0;
}

// Whether W_hh fits a block's shared memory beside the buffers of R rows a
// thread.
template <typename T>
static bool weight_fits(int hid, int rows, bool bwd, int max_optin) {
  return buffer_bytes<T>(hid, rows, bwd) + weight_bytes<T>(hid)
         <= (size_t)max_optin;
}

// R for a launch of shape s on the current card: the most rows a thread
// that still give every SM a block with W_hh in shared memory, 1 where even
// that leaves SMs without one; 8 where W_hh never fits (every block then
// reads it from L2 each step, and the most rows share each read).
template <typename T>
static int pick_rows(const Shape& s, bool bwd) {
  int dev = 0, sms = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!weight_fits<T>(s.hid, 1, bwd, max_optin)) return 8;
  const int rg = row_groups(s.hid);
  for (int r = 8; r > 1; r /= 2) {
    const long long blocks =
        (long long)s.ndir * ((s.batch + (long long)rg * r - 1) / (rg * r));
    if (blocks >= sms && weight_fits<T>(s.hid, r, bwd, max_optin)) return r;
  }
  return 1;
}

// Stage W_hh in shared memory where it fits beside the buffers: sets
// s->w_smem and the block's bytes; opts the kernel in above 48 KB.  0,
// -2 (the buffers alone exceed a block) or a CUDA error code.
template <typename T>
static int prepare(const void* kernel, Shape* s, int rows, bool bwd,
                   size_t* bytes) {
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t buf = buffer_bytes<T>(s->hid, rows, bwd);
  s->w_smem = weight_fits<T>(s->hid, rows, bwd, max_optin);
  *bytes = buf + (s->w_smem ? weight_bytes<T>(s->hid) : 0);
  if (*bytes > (size_t)max_optin) return -2;
  if (*bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

// f(std::integral_constant<int, R>) for R = rows (1, 2, 4 or 8).
template <typename F>
static int with_rows(int rows, F&& f) {
  switch (rows) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

// The kernel of a kind at T and R.
template <typename T, int R>
static const void* kernel_of(Kind kind) {
  switch (kind) {
    case kFwd: return (const void*)lstm_fwd_kernel<T, R>;
    case kBwd: return (const void*)lstm_bwd_kernel<T, R>;
    default: return (const void*)lstm_jvp_kernel<T, R>;
  }
}

// One launch of a kind over shape s: five pointers in the kernel's order.
template <typename T>
static int launch(Kind kind, Shape s, const void* p0, const void* p1,
                  const void* p2, const void* p3, void* p4, void* stream) {
  if (check(s) != 0) return -1;
  const bool bwd = kind == kBwd;
  return with_rows(pick_rows<T>(s, bwd), [&](auto r) {
    constexpr int R = decltype(r)::value;
    size_t bytes = 0;
    const int err = prepare<T>(kernel_of<T, R>(kind), &s, R, bwd, &bytes);
    if (err != 0) return err;
    const int rg = row_groups(s.hid), bt = rg * R;
    const dim3 grid((s.batch + bt - 1) / bt, s.ndir);
    const cudaStream_t st = (cudaStream_t)stream;
    const T *a = (const T*)p0, *b = (const T*)p1, *c = (const T*)p2,
            *e = (const T*)p3;
    T* o = (T*)p4;
    if (kind == kFwd)   // xg, W_hh^T -> y, and the gates and c (or null)
      lstm_fwd_kernel<T, R><<<grid, s.hid * rg, bytes, st>>>(
          s, a, b, o, (T*)p2, (T*)p3);
    else if (kind == kBwd)   // dy, W_hh, gates, c -> dg
      lstm_bwd_kernel<T, R><<<grid, s.hid * rg, bytes, st>>>(
          s, a, b, c, e, o);
    else                     // tg, W_hh^T, gates, c -> dh
      lstm_jvp_kernel<T, R><<<grid, s.hid * rg, bytes, st>>>(
          s, a, b, c, e, o);
    return (int)cudaGetLastError();
  });
}

// The entry points: five pointers (forward: xg, W_hh^T, y, gates or null,
// c or null; backward: dy, W_hh, gates, c, dg; tangent: tg, W_hh^T, gates,
// c, dh), steps, batch, H, directions, the reversed directions' bit mask,
// the stream.  0, -1 (a shape the kernels do not take), -2 (more shared
// memory than a block may use) or a CUDA error code.
#define LSTM_ENTRIES(suffix, T)                                               \
  extern "C" int egopose_lstm_fwd_##suffix(                                   \
      const void* xg, const void* wt, void* y, void* gates, void* cst,        \
      int steps, int batch, int hid, int ndir, int rev_mask, void* stream) {  \
    return launch<T>(kFwd, Shape{steps, batch, hid, ndir, rev_mask, 0}, xg,   \
                     wt, gates, cst, y, stream);                              \
  }                                                                           \
  extern "C" int egopose_lstm_bwd_##suffix(                                   \
      const void* dy, const void* wh, const void* gates, const void* cst,     \
      void* dg, int steps, int batch, int hid, int ndir, int rev_mask,        \
      void* stream) {                                                         \
    return launch<T>(kBwd, Shape{steps, batch, hid, ndir, rev_mask, 0}, dy,   \
                     wh, gates, cst, dg, stream);                             \
  }                                                                           \
  extern "C" int egopose_lstm_jvp_##suffix(                                   \
      const void* tg, const void* wt, const void* gates, const void* cst,     \
      void* dh, int steps, int batch, int hid, int ndir, int rev_mask,        \
      void* stream) {                                                         \
    return launch<T>(kJvp, Shape{steps, batch, hid, ndir, rev_mask, 0}, tg,   \
                     wt, gates, cst, dh, stream);                             \
  }

LSTM_ENTRIES(f32, float)
LSTM_ENTRIES(f64, double)

// Resources of one kernel (kind 0 forward, 1 backward, 2 tangent) for
// dtype (f64 0 float, 1 double) at B, H and the directions, with the R a
// launch of that shape picks: out[0] blocks per SM, out[1] registers per
// thread, out[2] dynamic shared bytes per block, out[3] local (spill) bytes
// per thread, out[4] batch rows per block, out[5] 1 where W_hh is staged in
// shared memory, out[6] R.
template <typename T>
static int occupancy(Shape s, Kind kind, int* out) {
  if (check(s) != 0) return -1;
  const bool bwd = kind == kBwd;
  const int rows = pick_rows<T>(s, bwd);
  return with_rows(rows, [&](auto r) {
    constexpr int R = decltype(r)::value;
    const void* k = kernel_of<T, R>(kind);
    size_t bytes = 0;
    const int err = prepare<T>(k, &s, R, bwd, &bytes);
    if (err != 0) return err;
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, k);
    if (e != cudaSuccess) return (int)e;
    const int rg = row_groups(s.hid);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k,
                                                      s.hid * rg, bytes);
    out[1] = attr.numRegs;
    out[2] = (int)bytes;
    out[3] = (int)attr.localSizeBytes;
    out[4] = rg * R;
    out[5] = s.w_smem;
    out[6] = R;
    return (int)e;
  });
}

extern "C" int egopose_lstm_occupancy(int f64, int kind, int batch, int hid,
                                      int ndir, int* out) {
  const Shape s{1, batch, hid, ndir, 0, 0};
  const Kind k = kind == 1 ? kBwd : kind == 2 ? kJvp : kFwd;
  return f64 ? occupancy<double>(s, k, out) : occupancy<float>(s, k, out);
}
