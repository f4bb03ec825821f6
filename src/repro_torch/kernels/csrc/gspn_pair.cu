// The opposite-direction pair scan and its adjoint for Hopper (sm_90a): the
// kernels of the vision main path, two launches of each per GSPN-2 block.
//
//   gspn_pair_fwd_kernel replaces gspn_scan_bidir_pallas
//     (src/repro/kernels/gspn_multidir.py, kernel #3): direction 0 walks
//     rows 0..H-1, direction 1 walks H-1..0, over one shared x.
//   gspn_pair_bwd_kernel replaces gspn_scan_bidir_bwd_pallas (same file,
//     kernel #4): direction 0 walks H-1..0, direction 1 walks 0..H-1 (the
//     forward's walks with the roles swapped), g written in f32.
//
// Both compute what the first design (gspn_scan.cu, D = 2) computed: the
// same operands, layouts and outputs, the carry reset every `chunk` rows of
// the walk, an f32 carry, each element by gspn::scan_cell or
// gspn::adjoint_cell, so the pair gives the bits of the single scan and of
// the quad on shared directions, and the pair adjoint's direction 0 the bits
// of the single adjoint.  Layouts (all contiguous): x (G,H,W); wl/wc/wr
// (2,G/cpw,H,W); lam, out (2,G,H,W); dy (2,G,H,W) in T, g (2,G,H,W) in f32.
// Plane g reads weight plane g / cpw.
//
// Bound.  Each input read once and each output written once: per (g,h,w)
// element the forward moves x once, lam and out twice and the six tap planes
// 6/cpw times, 32 bytes in f32 at cpw = 2; the adjoint moves dy, the taps at
// 3/cpw per direction and an f32 g, 14 bytes.  At G = 128 and
// N = 56 / 28 / 14 / 7 that is 3.83 / 0.96 / 0.24 / 0.060 us (forward) and
// 3.36 / 0.84 / 0.21 / 0.052 us (adjoint) at 3.35 TB/s; 7 and 9 operations
// per element are far below the f32 rate.
//
// What held the first design back:
//   1. a chain of H dependent rows per CTA, each one __syncthreads() plus the
//      latency of that row's loads, fetched only one row ahead into
//      registers: its time fit 1.3 us + 0.22 us per row, whatever the bytes;
//   2. in the training step the operands come from device memory, not the
//      L2, and a one-row prefetch cannot hide that latency (the adjoint ran
//      1.75x slower in the step than in graph replays);
//   3. each plane's CTA read its weight rows itself: cpw reads per group;
//   4. at W > 32 a row spans warps, so the neighbour exchange needed a
//      CTA-wide barrier every row.
//
// Design, and what each choice does about it:
//   - One CTA per (weight group, direction), one warp per plane of the group
//     (a group of more planes than the registers allow splits over CTAs,
//     `splits`), and at least 8 warps in all: every warp issues copies.
//     Both directions in one CTA would walk opposite ends of the plane at
//     every moment, so they would share no staged row, and one direction per
//     CTA doubles the CTAs in flight (128 at G = 128, cpw = 2, on 132 SMs).
//   - Lane l owns columns l, l+32, ..., l+32(K-1) (K a power of two, 32K >= W)
//     and keeps their carry in registers.  The +-1 neighbours come by
//     __shfl_sync from lanes l-1 and l+1, lane 0 taking lane 31's previous
//     slot and lane 31 lane 0's next: no barrier and no shared row per step
//     (item 4).  Strided columns make the reads of a staged row
//     conflict-free: the lanes of a warp read 32 consecutive words.
//   - The group's three tap rows are staged once for all its warps (item 3),
//     with each plane's x and lam rows (forward) or dy row (adjoint): a stage
//     row holds (2*planes + 3)*W and (planes + 3)*W stream items.
//   - The staging is a ring in shared memory filled by cp.async (items 1 and
//     2).  When the whole plane fits (H <= 64 rows and the shared memory: at
//     every main width, 88 KB at W = 56, cpw = 2, f32) it is one batch: all
//     of it is in flight from the start and one wait and one __syncthreads()
//     hand it to the warps, after which the walk reads only shared memory.
//     Taller planes stream through a ring of S <= 64 rows in 4 batches, one
//     cp.async group, one wait and one barrier per batch, the walk on batch
//     b while batches b+1.. load.  On the H100 each further batch of a
//     plane that fits costs more (its issue, wait and barrier) than
//     overlapping fill and walk gains (tools/pair_launch_sweep.py; PERF.md).
//   - Within the walk the next row's operands load from shared memory into a
//     second register set while the current row computes, four rows to an
//     unrolled step, and a walk without a chunk tests no reset, so the chain
//     of a row is two shuffles and four fused multiply-adds.  A row still takes
//     longer than that chain: each compute warp is the only one on its
//     scheduler (256 of them on 528 at the main shapes), so every dependent
//     instruction of the row, address arithmetic included, waits out its
//     latency.
//   - All threads copy every array's rows of a batch as one contiguous run
//     (a batch's rows are adjacent in memory in either walk order), warp w
//     the regions w, w + warps, ...: 16-byte copies for the run's 16-byte
//     aligned middle, 4-byte ones for its ends, the region placed at the
//     run's offset within its 16-byte block so that both sides agree.
//   - cp.async and not TMA: a tensor map needs 16-byte row pitches and a bulk
//     copy 16-byte aligned runs, and rows of 7 or 14 f32 items (28, 56 B) or
//     planes of 49 items give neither.  A bf16 run starting at a 2-byte
//     boundary is widened to the 4-byte words that cover it; the extra 2
//     bytes read lie in the same aligned word as a byte of the operand, so in
//     mapped memory.
//   - The launch shape (planes, warps, K, splits, batch, nbuf, shared bytes)
//     is chosen by one plain function, gspn_multidir.pair_launch_shape, and
//     checked here; shared memory above 48 KB is opted into per launch.
//
// ptxas -v (CUDA 12.9, sm_90a): registers per thread at K = 1 2 4 8 16
// 32, and stack / spill stores / spill loads in bytes where not 0.  No
// static shared memory: the ring is dynamic, sized by the launch shape.
//   fwd f32   52 62 121 165 239 255   K = 32: 96 / 180 / 184
//   fwd bf16  51 64 120 166 244 255   K = 32: 88 / 176 / 180
//   bwd f32   52 63 105 128 249 255   K = 32: 32 / 44 / 68
//   bwd bf16  52 63 105 128 255 255   K = 8: 8 / 8 / 12, K = 32: 8 / 8 / 20
// The main widths use K = 1 and 2, without spills.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "gspn_cell.cuh"

namespace {

using gspn::from_f32;
using gspn::to_f32;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBufs = 8;
constexpr int kMaxShared = 232448;  // bytes a CTA may use on the H100

// Threads per CTA the register budget allows at K columns per lane (two
// rows of operands in registers): 64 registers a thread at 1024 threads,
// 128 at 512, 255 at 256 and 128.
__host__ __device__ constexpr int max_threads(int k) {
  return k == 1 ? 1024 : k <= 4 ? 512 : k == 8 ? 256 : 128;
}

// Bytes of one (array, batch) region of a ring stage: `rows` rows of W
// items, placed at the offset the run's source has within its 16-byte block
// (up to 15 bytes) and ending on a whole 4-byte word, rounded up to 16 bytes
// so that every region starts 16-byte aligned.
__host__ __device__ inline int region_bytes(int rows, int W, int item) {
  return (rows * W * item + 18 + 15) / 16 * 16;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, uintptr_t src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// cp.async.wait_group takes an immediate: 0 <= n <= kMaxBufs - 1.
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Issue, from the 32 lanes of one warp, the copy of the `nbytes` at src into
// `region`: source address s goes to region + s - (src & ~15), so source and
// destination agree modulo 16 and the aligned middle of the run moves in
// 16-byte copies, its ragged ends in 4-byte ones.  The ends are widened to
// whole 4-byte words (a bf16 run may start or end mid-word).
template <typename T>
__device__ __forceinline__ void copy_run(unsigned char* region, const T* src, int nbytes,
                                         int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t w0 = a & ~static_cast<uintptr_t>(3);
  const uintptr_t w1 = (a + nbytes + 3) & ~static_cast<uintptr_t>(3);
  const uintptr_t b0 = (w0 + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t b1 = w1 & ~static_cast<uintptr_t>(15);
  // Shared address of source address s: base + s (mod 2^32).
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(region)) -
                        static_cast<uint32_t>(a & ~static_cast<uintptr_t>(15));
  if (b0 < b1) {
    for (uintptr_t c = b0 + 16u * lane; c < b1; c += 16u * 32u)
      cp_async16(base + static_cast<uint32_t>(c), c);
    const uintptr_t h = w0 + 4u * lane, t = b1 + 4u * lane;
    if (h < b0) cp_async4(base + static_cast<uint32_t>(h), h);
    if (t < w1) cp_async4(base + static_cast<uint32_t>(t), t);
  } else {  // under 32 bytes: at most 7 words
    const uintptr_t h = w0 + 4u * lane;
    if (h < w1) cp_async4(base + static_cast<uint32_t>(h), h);
  }
}

// Item 0 of the run copied from src by copy_run into region.
template <typename T>
__device__ __forceinline__ const T* run_items(const unsigned char* region, const T* src) {
  return reinterpret_cast<const T*>(region + (reinterpret_cast<uintptr_t>(src) & 15));
}

// Where each CTA sits: its weight group, direction, first plane of the group
// and number of planes it computes (one warp each; the other warps only copy).
// The grid is (G_w, splits, 2): group, part of the group, direction.
struct Cta {
  int gw, d, p0, np;
  __device__ Cta(int cpw, int P) {
    gw = static_cast<int>(blockIdx.x);
    d = static_cast<int>(blockIdx.z);
    p0 = static_cast<int>(blockIdx.y) * P;
    np = min(P, cpw - p0);
  }
};

// The batches of one walk: batch b holds walk steps b*batch .. +nb-1, which
// are memory rows row0 .. row0+nb-1 in either walk order.
struct Walk {
  int H, batch;
  bool reverse;
  __device__ int rows(int b) const { return min(batch, H - b * batch); }
  __device__ int row0(int b) const { return reverse ? H - b * batch - rows(b) : b * batch; }
};

// The ring: nbuf stages of `narr` regions of rb bytes; batch b lives in
// stage b % nbuf.  Warp w issues the copies of regions w, w + warps, ...
// of every batch, one cp.async group per batch and thread.  When all nbat
// batches fit (the whole plane) they are all issued up front; otherwise
// nbuf - 1 are, and batch b + nbuf - 1 is issued once batch b - 1's stage
// is free.
struct Ring {
  unsigned char* base;
  int narr, rb, nbuf, nbat;
  __device__ unsigned char* stage(int b) const {
    return base + static_cast<size_t>(b % nbuf) * narr * rb;
  }
  __device__ bool refills() const { return nbat > nbuf; }
  __device__ int ahead() const { return refills() ? nbuf - 1 : nbat; }
  // Groups that may still be in flight once batch b has landed.
  __device__ int pending(int b) const { return refills() ? nbuf - 2 : nbat - 1 - b; }
};

// This lane's slots: column lane + 32k is valid when it is below W.
template <int K> struct Lanes {
  bool valid[K];
  __device__ Lanes(int lane, int W) {
#pragma unroll
    for (int k = 0; k < K; ++k) valid[k] = lane + 32 * k < W;
  }
};

// N staged arrays' rows at this lane's column, walked through a batch: one
// pointer per array, stepped by `step` items (negative on a reverse walk).
template <int N, int K, typename T> struct Rows {
  const T* p[N];
  int step;
  // This lane's operands of the current row as f32, 0 in masked slots.
  __device__ __forceinline__ void load(float (&v)[N][K], const Lanes<K>& ln) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) v[i][k] = ln.valid[k] ? to_f32(p[i][32 * k]) : 0.f;
  }
  __device__ __forceinline__ void advance(bool more) {
    const int s = more ? step : 0;
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] += s;
  }
};

// The shuffles of a row step: v of lane l-1 and of lane l+1 at every slot,
// lane 0 taking lane 31's previous slot and lane 31 lane 0's next.  At the
// row's two ends (lane 0 at slot 0, lane 31 at slot K-1) the wrapped value
// arrives; callers zero what it would reach.
template <int K>
__device__ __forceinline__ void from_left(const float (&v)[K], int lane, float (&out)[K]) {
  float up[K];
#pragma unroll
  for (int k = 0; k < K; ++k) up[k] = __shfl_sync(kFull, v[k], (lane + 31) & 31);
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = k > 0 && lane == 0 ? up[k > 0 ? k - 1 : 0] : up[k];
}
template <int K>
__device__ __forceinline__ void from_right(const float (&v)[K], int lane, float (&out)[K]) {
  float down[K];
#pragma unroll
  for (int k = 0; k < K; ++k) down[k] = __shfl_sync(kFull, v[k], (lane + 1) & 31);
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k] = k + 1 < K && lane == 31 ? down[k + 1 < K ? k + 1 : k] : down[k];
}

// Walk the nb rows of a batch: row(v) computes one row from its operands v
// while the next row's operands load from shared memory (two register sets
// used in turn, four rows to an unrolled step; at K = 32 one set, for
// registers).  The pointers stop at the batch's last row, so no read leaves
// it.
template <int N, int K, typename T, typename Row>
__device__ __forceinline__ void walk_batch(Rows<N, K, T>& rows, const Lanes<K>& ln, int nb,
                                           Row row) {
  if constexpr (K >= 32) {
    for (int q = 0; q < nb; ++q) {
      float v[N][K];
      rows.load(v, ln);
      rows.advance(q + 1 < nb);
      row(v);
    }
  } else {
    float a[N][K], b[N][K];
    rows.load(a, ln);
    int q = 0;
    for (; q + 4 <= nb; q += 4) {
      rows.advance(true);
      rows.load(b, ln);
      row(a);
      rows.advance(true);
      rows.load(a, ln);
      row(b);
      rows.advance(true);
      rows.load(b, ln);
      row(a);
      rows.advance(q + 4 < nb);
      rows.load(a, ln);
      row(b);
    }
    for (; q < nb; ++q) {  // a holds row q
      row(a);
      if (q + 1 < nb) {
        rows.advance(true);
        rows.load(a, ln);
      }
    }
  }
}

// Rows of the walk until the next carry reset: every `chunk` rows from the
// first, never when chunk <= 0.
struct Reset {
  int left, chunk;
  __device__ explicit Reset(int c) : left(c > 0 ? 1 : 0x7fffffff), chunk(c) {}
  __device__ __forceinline__ bool now() {
    if (--left) return false;
    left = chunk;
    return true;
  }
};

template <int K, typename T>
__global__ void __launch_bounds__(max_threads(K))
gspn_pair_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wl,
                     const T* __restrict__ wc, const T* __restrict__ wr,
                     const T* __restrict__ lam, T* __restrict__ out, int G, int H, int W,
                     int cpw, int chunk, int P, int batch, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Cta cta(cpw, P);
  const int warps = static_cast<int>(blockDim.x) / 32;
  const int warp = static_cast<int>(threadIdx.x) / 32, lane = static_cast<int>(threadIdx.x) % 32;
  const size_t plane = static_cast<size_t>(H) * W;
  const int g0 = cta.gw * cpw + cta.p0;  // first plane of this CTA
  const Walk walk{H, batch, cta.d == 1};
  // Regions of a stage: 0..2 the taps, 3+p plane p's x, 3+P+p its lam.
  const Ring ring{smem, 3 + 2 * P, region_bytes(batch, W, static_cast<int>(sizeof(T))), nbuf,
                  (H + batch - 1) / batch};
  const size_t tap_off = (static_cast<size_t>(cta.d) * gridDim.x + cta.gw) * plane;
  const T *twl = wl + tap_off, *twc = wc + tap_off, *twr = wr + tap_off;
  const T* xg = x + static_cast<size_t>(g0) * plane;
  const T* lamg = lam + (static_cast<size_t>(cta.d) * G + g0) * plane;
  auto source = [&](int a) -> const T* {  // plane of region a; null if not this CTA's
    if (a < 3) return a == 0 ? twl : a == 1 ? twc : twr;
    const int p = a < 3 + P ? a - 3 : a - 3 - P;
    if (p >= cta.np) return nullptr;
    return (a < 3 + P ? xg : lamg) + static_cast<size_t>(p) * plane;
  };
  auto issue = [&](int b) {
    if (b < ring.nbat) {
      unsigned char* stage = ring.stage(b);
      const size_t off = static_cast<size_t>(walk.row0(b)) * W;
      const int nbytes = walk.rows(b) * W * static_cast<int>(sizeof(T));
      for (int a = warp; a < ring.narr; a += warps)
        if (const T* src = source(a)) copy_run(stage + a * ring.rb, src + off, nbytes, lane);
    }
    cp_commit();
  };

  const bool active = warp < cta.np;
  const Lanes<K> ln(lane, W);
  T* outg = out + (static_cast<size_t>(cta.d) * G + g0 + warp) * plane;
  float h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) h[k] = 0.f;
  Reset reset(chunk);

  for (int b = 0; b < ring.ahead(); ++b) issue(b);
  for (int b = 0; b < ring.nbat; ++b) {
    cp_wait(ring.pending(b));
    __syncthreads();  // batch b visible to every warp; batch b-1's stage free
    if (ring.refills()) issue(b + nbuf - 1);
    if (!active) continue;
    const unsigned char* stage = ring.stage(b);
    const size_t off = static_cast<size_t>(walk.row0(b)) * W;
    const int nb = walk.rows(b);
    // This lane's column in the first walked row of the batch.
    const int first = (walk.reverse ? (nb - 1) * W : 0) + lane, step = walk.reverse ? -W : W;
    Rows<5, K, T> rows{{run_items(stage, twl + off) + first,
                        run_items(stage + ring.rb, twc + off) + first,
                        run_items(stage + 2 * ring.rb, twr + off) + first,
                        run_items(stage + (3 + P + warp) * ring.rb, source(3 + P + warp) + off) +
                            first,
                        run_items(stage + (3 + warp) * ring.rb, source(3 + warp) + off) + first},
                       step};
    T* o = outg + off + first;
    // The main path has no chunk: its walk carries no reset test.
    auto walk_rows = [&](auto chunked) {
      walk_batch(rows, ln, nb, [&](float (&v)[5][K]) {
        if constexpr (decltype(chunked)::value) {
          if (reset.now()) {
#pragma unroll
            for (int k = 0; k < K; ++k) h[k] = 0.f;
          }
        }
        float left[K], right[K];
        from_left(h, lane, left);
        from_right(h, lane, right);
        // The row's ends have no neighbour: their taps meet the wrapped values.
        if (lane == 0) v[0][0] = 0.f;
        if (lane == 31) v[2][K - 1] = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          // Masked slots have all five operands 0, so their carry stays 0.
          h[k] = gspn::scan_cell(v[0][k], left[k], v[1][k], h[k], v[2][k], right[k],
                                 v[3][k], v[4][k]);
          if (ln.valid[k]) o[32 * k] = from_f32<T>(h[k]);
        }
        o += step;
      });
    };
    if (chunk > 0)
      walk_rows(std::true_type{});
    else
      walk_rows(std::false_type{});
  }
}

template <int K, typename T>
__global__ void __launch_bounds__(max_threads(K))
gspn_pair_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ wl,
                     const T* __restrict__ wc, const T* __restrict__ wr,
                     float* __restrict__ gout, int G, int H, int W, int cpw, int chunk, int P,
                     int batch, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Cta cta(cpw, P);
  const int warps = static_cast<int>(blockDim.x) / 32;
  const int warp = static_cast<int>(threadIdx.x) / 32, lane = static_cast<int>(threadIdx.x) % 32;
  const size_t plane = static_cast<size_t>(H) * W;
  const int g0 = cta.gw * cpw + cta.p0;
  const Walk walk{H, batch, cta.d == 0};
  // Regions of a stage: 0..2 the taps, 3+p plane p's dy.
  const Ring ring{smem, 3 + P, region_bytes(batch, W, static_cast<int>(sizeof(T))), nbuf,
                  (H + batch - 1) / batch};
  const size_t tap_off = (static_cast<size_t>(cta.d) * gridDim.x + cta.gw) * plane;
  const T *twl = wl + tap_off, *twc = wc + tap_off, *twr = wr + tap_off;
  const T* dyg = dy + (static_cast<size_t>(cta.d) * G + g0) * plane;
  auto source = [&](int a) -> const T* {
    if (a < 3) return a == 0 ? twl : a == 1 ? twc : twr;
    return a - 3 < cta.np ? dyg + static_cast<size_t>(a - 3) * plane : nullptr;
  };
  auto issue = [&](int b) {
    if (b < ring.nbat) {
      unsigned char* stage = ring.stage(b);
      const size_t off = static_cast<size_t>(walk.row0(b)) * W;
      const int nbytes = walk.rows(b) * W * static_cast<int>(sizeof(T));
      for (int a = warp; a < ring.narr; a += warps)
        if (const T* src = source(a)) copy_run(stage + a * ring.rb, src + off, nbytes, lane);
    }
    cp_commit();
  };

  const bool active = warp < cta.np;
  const Lanes<K> ln(lane, W);
  float* outg = gout + (static_cast<size_t>(cta.d) * G + g0 + warp) * plane;
  // This lane's products of the previously walked row.
  float pl[K], pc[K], pr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) pl[k] = pc[k] = pr[k] = 0.f;
  Reset reset(chunk);

  for (int b = 0; b < ring.ahead(); ++b) issue(b);
  for (int b = 0; b < ring.nbat; ++b) {
    cp_wait(ring.pending(b));
    __syncthreads();  // batch b visible to every warp; batch b-1's stage free
    if (ring.refills()) issue(b + nbuf - 1);
    if (!active) continue;
    const unsigned char* stage = ring.stage(b);
    const size_t off = static_cast<size_t>(walk.row0(b)) * W;
    const int nb = walk.rows(b);
    const int first = (walk.reverse ? (nb - 1) * W : 0) + lane, step = walk.reverse ? -W : W;
    Rows<4, K, T> rows{{run_items(stage, twl + off) + first,
                        run_items(stage + ring.rb, twc + off) + first,
                        run_items(stage + 2 * ring.rb, twr + off) + first,
                        run_items(stage + (3 + warp) * ring.rb, source(3 + warp) + off) + first},
                       step};
    float* o = outg + off + first;
    auto walk_rows = [&](auto chunked) {
      walk_batch(rows, ln, nb, [&](float (&v)[4][K]) {
        if constexpr (decltype(chunked)::value) {
          if (reset.now()) {
#pragma unroll
            for (int k = 0; k < K; ++k) pl[k] = pc[k] = pr[k] = 0.f;
          }
        }
        // Pl at column j+1 and Pr at column j-1, 0 past the row's ends.
        float pl_r[K], pr_l[K];
        from_right(pl, lane, pl_r);
        from_left(pr, lane, pr_l);
        if (lane == 31) pl_r[K - 1] = 0.f;
        if (lane == 0) pr_l[0] = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float gv = gspn::adjoint_cell(v[3][k], pl_r[k], pc[k], pr_l[k]);
          if (ln.valid[k]) o[32 * k] = gv;
          // Masked slots have zero taps, so their products stay 0.
          pl[k] = __fmul_rn(v[0][k], gv); pc[k] = __fmul_rn(v[1][k], gv);
          pr[k] = __fmul_rn(v[2][k], gv);
        }
        o += step;
      });
    };
    if (chunk > 0)
      walk_rows(std::true_type{});
    else
      walk_rows(std::false_type{});
  }
}

// Check a launch shape against the operands and this file's layout;
// cudaSuccess if it can run.
cudaError_t check_shape(int G, int H, int W, int cpw, int P, int warps, int k, int splits,
                        int batch, int nbuf, int smem, int arrays_per_plane, int item) {
  const bool k_ok = k == 1 || k == 2 || k == 4 || k == 8 || k == 16 || k == 32;
  if (G < 1 || H < 1 || W < 1 || cpw < 1 || G % cpw || !k_ok || 32 * k < W || P < 1 ||
      warps < P || 32 * warps > max_threads(k) || splits < 1 || P * splits < cpw ||
      P * (splits - 1) >= cpw || batch < 1 || nbuf < 1 || nbuf > kMaxBufs ||
      (nbuf == 1 && batch < H))
    return cudaErrorInvalidValue;
  const long need = static_cast<long>(nbuf) * (3 + arrays_per_plane * P) *
                    region_bytes(batch, W, item);
  if (need > smem || smem > kMaxShared) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The launch shape of gspn_multidir.pair_launch_shape.
struct Shape {
  int P, warps, k, splits, batch, nbuf, smem;
};

template <int K, typename T>
cudaError_t launch_fwd(const void* x, const void* wl, const void* wc, const void* wr,
                       const void* lam, void* out, int G, int H, int W, int cpw, int chunk,
                       const Shape& sh, cudaStream_t stream) {
  const cudaError_t err = opt_in(gspn_pair_fwd_kernel<K, T>, sh.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(G / cpw), static_cast<unsigned>(sh.splits), 2);
  gspn_pair_fwd_kernel<K, T><<<grid, 32 * sh.warps, sh.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wl), static_cast<const T*>(wc),
      static_cast<const T*>(wr), static_cast<const T*>(lam), static_cast<T*>(out), G, H, W,
      cpw, chunk, sh.P, sh.batch, sh.nbuf);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t launch_bwd(const void* dy, const void* wl, const void* wc, const void* wr,
                       void* g, int G, int H, int W, int cpw, int chunk, const Shape& sh,
                       cudaStream_t stream) {
  const cudaError_t err = opt_in(gspn_pair_bwd_kernel<K, T>, sh.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(G / cpw), static_cast<unsigned>(sh.splits), 2);
  gspn_pair_bwd_kernel<K, T><<<grid, 32 * sh.warps, sh.smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(wl), static_cast<const T*>(wc),
      static_cast<const T*>(wr), static_cast<float*>(g), G, H, W, cpw, chunk, sh.P, sh.batch,
      sh.nbuf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const void* x, const void* wl, const void* wc, const void* wr,
                         const void* lam, void* out, int G, int H, int W, int cpw, int chunk,
                         const Shape& sh, cudaStream_t s) {
  switch (sh.k) {
    case 1: return launch_fwd<1, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 2: return launch_fwd<2, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 4: return launch_fwd<4, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 8: return launch_fwd<8, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 16: return launch_fwd<16, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 32: return launch_fwd<32, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_bwd(const void* dy, const void* wl, const void* wc, const void* wr,
                         void* g, int G, int H, int W, int cpw, int chunk, const Shape& sh,
                         cudaStream_t s) {
  switch (sh.k) {
    case 1: return launch_bwd<1, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 2: return launch_bwd<2, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 4: return launch_bwd<4, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 8: return launch_bwd<8, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 16: return launch_bwd<16, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 32: return launch_bwd<32, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The pair forward.  dtype: 0 = float32, 1 = bfloat16.  chunk <= 0: no
// reset.  planes, warps, k, splits, batch, nbuf, smem: the launch shape of
// gspn_multidir.pair_launch_shape (ring depth S = nbuf * batch rows).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gspn_pair_launch(int dtype, const void* x, const void* wl, const void* wc,
                                const void* wr, const void* lam, void* out, int G, int H,
                                int W, int cpw, int chunk, int planes, int warps, int k,
                                int splits, int batch, int nbuf, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh{planes, warps, k, splits, batch, nbuf, smem};
  cudaError_t err = check_shape(G, H, W, cpw, planes, warps, k, splits, batch, nbuf, smem, 2,
                                dtype == 1 ? 2 : 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0)
    err = dispatch_fwd<float>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
  else if (dtype == 1)
    err = dispatch_fwd<__nv_bfloat16>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The pair adjoint.  dtype of dy and the taps: 0 = float32, 1 = bfloat16; g
// is float32.  The other arguments as for gspn_pair_launch.
extern "C" int gspn_pair_bwd_launch(int dtype, const void* dy, const void* wl, const void* wc,
                                    const void* wr, void* g, int G, int H, int W, int cpw,
                                    int chunk, int planes, int warps, int k, int splits,
                                    int batch, int nbuf, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh{planes, warps, k, splits, batch, nbuf, smem};
  cudaError_t err = check_shape(G, H, W, cpw, planes, warps, k, splits, batch, nbuf, smem, 1,
                                dtype == 1 ? 2 : 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0)
    err = dispatch_bwd<float>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
  else if (dtype == 1)
    err = dispatch_bwd<__nv_bfloat16>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* gspn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
