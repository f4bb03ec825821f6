// GSPN line scan for Hopper (sm_90a) and its adjoint, in the first design
// of the port: a thread per column.  The forward template runs over the
// direction count D (1 or 4) and the stream type T, the adjoint over T.  The
// opposite-direction pair (kernels #3 and #4 of the main path) moved to
// gspn_pair.cu, which gives it a warp per plane and a prefetch ring; moving
// these kernels onto that design is the next step.
//
// ---- Forward: gspn_scan_kernel -------------------------------------------
//
//   D = 1: the single top-to-bottom scan, replacing the Pallas
//          gspn_scan_fwd_pallas (src/repro/kernels/gspn_scan.py), with the
//          GSPN-local carry reset every `chunk` rows.
//   D = 4: all four directions in one launch on a square N x N grid,
//          replacing gspn_scan_quad_pallas (src/repro/kernels/gspn_multidir.py):
//          x arrives stacked with its transpose, xx (2,G,N,N); direction d
//          reads orientation d >> 1 of xx and walks rows in reverse when
//          d & 1, so directions (tb, bt, lr, rl) are (0, 1, 2, 3), the last
//          two in transposed geometry.  No chunk: the quad is one-shot.
//
// Recurrence (f32 arithmetic and carry, stored in T), gspn::scan_cell:
//   h[i,j] = wl[i,j]*h[p,j-1] + wc[i,j]*h[p,j] + wr[i,j]*h[p,j+1] + lam[i,j]*x[i,j]
// with p the previously walked row, h = 0 before the first row of a chunk,
// and out-of-range neighbours 0.  Plane g reads weight plane g / cpw.
//
// Layout (all contiguous): x (G,H,W), or xx (2,G,H,W) for D = 4;
// wl/wc/wr (D,G/cpw,H,W); lam and out (D,G,H,W).
//
// Design: one CTA per (plane, direction), blockDim = roundup(W, 32), thread
// j owns column j and keeps its own h in a register.  The previous row is
// staged in shared memory (two buffers of W+2 floats with zero pads at both
// ends, so the +-1 neighbours need no edge test) and one __syncthreads()
// per row separates the write of row r from the reads of row r.  The five
// input values of the next row are loaded into registers while the current
// row computes, so one row's load latency hides behind the previous row.
//
// Bound: each input is read once and each output written once, 18 bytes per
// (g,h,w) element for the single scan in f32 at cpw = 2, but every row is a
// dependent step (a barrier plus the latency of the row's loads), so at the
// vision shapes the kernel is bound by the chain of H row latencies, not by
// bytes.  The wrappers' docstrings give the numbers.
//
// Bound of the quad (D = 4), per (g,h,w) element of the function it computes
// (gspn_scan_quad, stacking included): x read once, lam 4, out 4 and the
// twelve tap planes 12/cpw: 60 bytes in f32 at cpw = 2.  At G = 128 and
// N = 56 / 28 / 14 / 7 that is 24.1 / 6.02 / 1.51 / 0.38 MB per call,
// 7.19 / 1.80 / 0.45 / 0.11 us at 3.35 TB/s; at G = 32, N = 256 it is
// 126 MB, 37.6 us.  The kernel itself reads x twice, as xx (64 bytes per
// element); the wrapper's stacking copy (x read, its transpose written)
// builds xx outside it, as in the reference.  4·G CTAs of roundup(N, 32) threads
// (512 CTAs of 64 threads at G = 128, N = 56) all fit on 132 SMs at once,
// so each still runs its chain of N row latencies.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "gspn_cell.cuh"

namespace {

using gspn::from_f32;
using gspn::to_f32;

template <int D, typename T>
__global__ void gspn_scan_kernel(const T* __restrict__ x, const T* __restrict__ wl,
                                 const T* __restrict__ wc, const T* __restrict__ wr,
                                 const T* __restrict__ lam, T* __restrict__ out,
                                 int G, int H, int W, int cpw, int chunk) {
  extern __shared__ float s_prev[];  // 2 x (W + 2)
  const int g = blockIdx.x;
  const int d = (D > 1) ? static_cast<int>(blockIdx.y) : 0;
  const int j = threadIdx.x;
  const bool active = j < W;
  const bool reverse = (D > 1) && (d & 1);
  const int ori = (D == 4) ? (d >> 1) : 0;  // orientation of xx (quad only)
  const int Gw = G / cpw;
  const size_t plane = static_cast<size_t>(H) * W;

  const T* xg = x + (static_cast<size_t>(ori) * G + g) * plane;
  const size_t w_off = (static_cast<size_t>(d) * Gw + g / cpw) * plane;
  const T* wlg = wl + w_off;
  const T* wcg = wc + w_off;
  const T* wrg = wr + w_off;
  const size_t o_off = (static_cast<size_t>(d) * G + g) * plane;
  const T* lamg = lam + o_off;
  T* outg = out + o_off;

  const int ws = W + 2;
  // Zero pads; blockDim >= 32, so thread 1 exists even when W == 1.  The
  // first row's barrier orders these writes before any read.
  if (j == 0) { s_prev[0] = 0.f; s_prev[ws] = 0.f; }
  if (j == 1) { s_prev[W + 1] = 0.f; s_prev[ws + W + 1] = 0.f; }

  float nx = 0.f, nlam = 0.f, nwl = 0.f, nwc = 0.f, nwr = 0.f;
  if (active && H > 0) {
    const size_t k = static_cast<size_t>(reverse ? H - 1 : 0) * W + j;
    nx = to_f32(xg[k]); nlam = to_f32(lamg[k]);
    nwl = to_f32(wlg[k]); nwc = to_f32(wcg[k]); nwr = to_f32(wrg[k]);
  }

  float hp = 0.f;
  for (int r = 0; r < H; ++r) {
    const int i = reverse ? H - 1 - r : r;
    const float cx = nx, clam = nlam, cwl = nwl, cwc = nwc, cwr = nwr;
    if (active && r + 1 < H) {
      const size_t k = static_cast<size_t>(reverse ? i - 1 : i + 1) * W + j;
      nx = to_f32(xg[k]); nlam = to_f32(lamg[k]);
      nwl = to_f32(wlg[k]); nwc = to_f32(wcg[k]); nwr = to_f32(wrg[k]);
    }
    if (chunk > 0 && r % chunk == 0) hp = 0.f;
    float* buf = s_prev + (r & 1) * ws;
    if (active) buf[j + 1] = hp;
    __syncthreads();
    if (active) {
      const float h = gspn::scan_cell(cwl, buf[j], cwc, hp, cwr, buf[j + 2], clam, cx);
      outg[static_cast<size_t>(i) * W + j] = from_f32<T>(h);
      hp = h;
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* x, const void* wl, const void* wc, const void* wr,
                   const void* lam, void* out, int G, int H, int W, int cpw, int chunk,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(G), D);
  const unsigned threads = static_cast<unsigned>((W + 31) / 32 * 32);
  const size_t smem = 2 * static_cast<size_t>(W + 2) * sizeof(float);
  gspn_scan_kernel<D, T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wl), static_cast<const T*>(wc),
      static_cast<const T*>(wr), static_cast<const T*>(lam), static_cast<T*>(out),
      G, H, W, cpw, chunk);
  return cudaGetLastError();
}

}  // namespace

// ndir: 1 or 4 (x is then xx, H == W and chunk <= 0).  dtype: 0 =
// float32, 1 = bfloat16.  chunk <= 0: no reset.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int gspn_scan_launch(int ndir, int dtype, const void* x, const void* wl,
                                const void* wc, const void* wr, const void* lam, void* out,
                                int G, int H, int W, int cpw, int chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndir == 4 && (H != W || chunk > 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (ndir == 1 && dtype == 0)
    return launch<1, float>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, s);
  if (ndir == 1 && dtype == 1)
    return launch<1, __nv_bfloat16>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, s);
  if (ndir == 4 && dtype == 0)
    return launch<4, float>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, s);
  if (ndir == 4 && dtype == 1)
    return launch<4, __nv_bfloat16>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- Adjoint: gspn_scan_bwd_kernel ---------------------------------------
//
// The adjoint of the top-to-bottom scan, walking rows H-1..0, replacing the
// Pallas gspn_scan_bwd_pallas (src/repro/kernels/gspn_scan.py) without its
// four flipped input copies and the flip of its output.
//
// Recurrence (f32 arithmetic, carry and output), gspn::adjoint_cell:
//   g[i,j] = dy[i,j] + Pl[j+1] + Pc[j] + Pr[j-1]
//   Pl, Pc, Pr = wl[i]*g[i], wc[i]*g[i], wr[i]*g[i]     (this row's taps)
// with P* the products of the previously walked row, 0 before the first
// row of each chunk of the walk and out of range.  Plane g reads weight
// plane g / cpw.
//
// Layout (all contiguous): dy (G,H,W) in T; wl/wc/wr (G/cpw,H,W) in T;
// g (G,H,W) in f32.
//
// Design: the forward's.  One CTA per plane, thread j owns column j; Pc
// stays in the thread's register, Pl and Pr go to two double-buffered
// shared rows with zero pads (they are read at j+1 and j-1), one
// __syncthreads() per row, and the next row's four inputs are loaded into
// registers while the current row computes.
//
// Bound: per (g,h,w) element dy is read once, the three taps 3/cpw times
// and g written once in f32: 14 bytes in f32 at cpw = 2.  As in the
// forward, the chain of H dependent rows (a barrier and one row's load
// latency each) sets the time at the vision shapes, not the bytes.

namespace {

template <typename T>
__global__ void gspn_scan_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ wl,
                                     const T* __restrict__ wc, const T* __restrict__ wr,
                                     float* __restrict__ gout, int G, int H, int W, int cpw,
                                     int chunk) {
  extern __shared__ float s_prod[];  // [buffer 0: Pl, Pr][buffer 1: Pl, Pr], W + 2 each
  const int g = blockIdx.x;
  const int j = threadIdx.x;
  const bool active = j < W;
  const size_t plane = static_cast<size_t>(H) * W;

  const T* dyg = dy + g * plane;
  float* outg = gout + g * plane;
  const size_t w_off = static_cast<size_t>(g / cpw) * plane;
  const T* wlg = wl + w_off;
  const T* wcg = wc + w_off;
  const T* wrg = wr + w_off;

  const int ws = W + 2;
  // Zero pads of the four shared rows; the first row's barrier orders
  // these writes before any read.
  if (j == 0)
    for (int b = 0; b < 4; ++b) s_prod[b * ws] = 0.f;
  if (j == 1)
    for (int b = 0; b < 4; ++b) s_prod[b * ws + W + 1] = 0.f;

  float ndy = 0.f, nwl = 0.f, nwc = 0.f, nwr = 0.f;
  if (active && H > 0) {
    const size_t k = static_cast<size_t>(H - 1) * W + j;
    ndy = to_f32(dyg[k]);
    nwl = to_f32(wlg[k]); nwc = to_f32(wcg[k]); nwr = to_f32(wrg[k]);
  }

  float pl = 0.f, pc = 0.f, pr = 0.f;
  for (int r = 0; r < H; ++r) {
    const int i = H - 1 - r;
    const float cdy = ndy, cwl = nwl, cwc = nwc, cwr = nwr;
    if (active && r + 1 < H) {
      const size_t k = static_cast<size_t>(i - 1) * W + j;
      ndy = to_f32(dyg[k]);
      nwl = to_f32(wlg[k]); nwc = to_f32(wcg[k]); nwr = to_f32(wrg[k]);
    }
    if (chunk > 0 && r % chunk == 0) { pl = 0.f; pc = 0.f; pr = 0.f; }
    float* buf_l = s_prod + (r & 1) * 2 * ws;
    float* buf_r = buf_l + ws;
    if (active) { buf_l[j + 1] = pl; buf_r[j + 1] = pr; }
    __syncthreads();
    if (active) {
      const float gv = gspn::adjoint_cell(cdy, buf_l[j + 2], pc, buf_r[j]);
      outg[static_cast<size_t>(i) * W + j] = gv;
      pl = __fmul_rn(cwl, gv); pc = __fmul_rn(cwc, gv); pr = __fmul_rn(cwr, gv);
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* dy, const void* wl, const void* wc, const void* wr,
                       float* gout, int G, int H, int W, int cpw, int chunk,
                       cudaStream_t stream) {
  const unsigned threads = static_cast<unsigned>((W + 31) / 32 * 32);
  const size_t smem = 4 * static_cast<size_t>(W + 2) * sizeof(float);
  gspn_scan_bwd_kernel<T><<<static_cast<unsigned>(G), threads, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(wl), static_cast<const T*>(wc),
      static_cast<const T*>(wr), gout, G, H, W, cpw, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype of dy and the taps: 0 = float32, 1 = bfloat16; g is float32.
// chunk <= 0: no reset.  Returns the cudaError_t of the launch.
extern "C" int gspn_scan_bwd_launch(int dtype, const void* dy, const void* wl, const void* wc,
                                    const void* wr, void* g, int G, int H, int W, int cpw,
                                    int chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(g);
  if (dtype == 0) return launch_bwd<float>(dy, wl, wc, wr, out, G, H, W, cpw, chunk, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(dy, wl, wc, wr, out, G, H, W, cpw, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gspn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
