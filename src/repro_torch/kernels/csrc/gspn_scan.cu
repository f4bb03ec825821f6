// The adjoint of the single GSPN line scan for Hopper (sm_90a), in the first
// design of the port: a thread per column.  It is the last kernel of that
// design: the forward scans (#1, #3 and #5) are the D = 1, 2 and 4
// instances of gspn_fwd_kernel in gspn_pair.cu, and the pair adjoint (#4)
// runs there too; moving this one onto that design (a D = 1 adjoint) is the
// next step, after which this file goes.
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
// Design: one CTA per plane, thread j owns column j and keeps its Pc in a
// register; Pl and Pr go to two double-buffered shared rows with zero pads
// (they are read at j+1 and j-1), one __syncthreads() per row, and the next
// row's four inputs are loaded into registers while the current row
// computes.
//
// Bound: per (g,h,w) element dy is read once, the three taps 3/cpw times
// and g written once in f32: 14 bytes in f32 at cpw = 2.  The chain of H
// dependent rows (a barrier and one row's load latency each) sets the time
// at the vision shapes, not the bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "gspn_cell.cuh"

namespace {

using gspn::to_f32;

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
