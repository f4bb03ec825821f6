// The GSPN scan forward over 1, 2 or 4 directions, and its adjoint over 1 or
// 2, for Hopper (sm_90a).
//
//   gspn_fwd_kernel<D, K, T>, one template over the direction count D:
//     D = 1 replaces gspn_scan_fwd_pallas (src/repro/kernels/gspn_scan.py,
//       kernel #1): rows 0..H-1, the carry reset every `chunk` rows (the
//       LM mixer's passes need it);
//     D = 2 replaces gspn_scan_bidir_pallas (src/repro/kernels/
//       gspn_multidir.py, kernel #3, the vision main path): direction 0 walks
//       rows 0..H-1, direction 1 walks H-1..0, over one shared x;
//     D = 4 replaces gspn_scan_quad_pallas (same file, kernel #5): all four
//       directions of a square N x N grid in one launch, (tb, bt, lr, rl) =
//       (0, 1, 2, 3).  Direction d walks in reverse when d is odd; 2 and 3
//       run in transposed geometry, so their taps, lam and out arrive and
//       leave transposed (rows of entry 2 are the original columns), and
//       they read x itself transposed: walk step i needs column i of x.  The
//       reference stacks x with its transpose first, because a BlockSpec
//       cannot express a transposed read; here x is read in place.  No
//       chunk: the quad is one-shot.
//   gspn_bwd_kernel<D, K, L, T>, the adjoint template over D, g written in
//   f32, direction 0 walking H-1..0 and direction 1 0..H-1 (the forward's
//   walks with the roles swapped):
//     D = 1 replaces gspn_scan_bwd_pallas (src/repro/kernels/gspn_scan.py,
//       kernel #2), the `chunk` reset kept for the LM mixer; a row of more
//       than 128 columns is laid out over several warps (layout L: bands
//       from the ring, or windows from device memory; at the kernel);
//     D = 2 replaces gspn_scan_bidir_bwd_pallas (src/repro/kernels/
//       gspn_multidir.py, kernel #4, the vision training step).
//
// Every element goes through gspn::scan_cell or gspn::adjoint_cell, with an
// f32 carry and the carry reset every `chunk` rows of the walk, so the three
// forward instances agree bit for bit on shared directions and the pair
// adjoint's direction 0 gives the bits of the single adjoint, banded or not.
// Layouts (all contiguous): x (G,H,W); wl/wc/wr (D,G/cpw,H,W); lam, out, dy
// (D,G,H,W) in T, g (D,G,H,W) in f32, the leading axis absent for D = 1.
// Plane g reads weight plane g / cpw.
//
// Bound.  Each input read once and each output written once: per (g,h,w)
// element the forward moves x once, lam and out D times each and the 3D tap
// planes 3D/cpw times: 18 / 32 / 60 bytes in f32 at cpw = 2 for D = 1 / 2 /
// 4; the adjoint moves dy, the taps at 3/cpw per direction and an f32 g, 14
// bytes per direction.  At G = 128 and N = 56 / 28 / 14 / 7 that is 2.16 /
// 0.54 / 0.135 / 0.034 us (D = 1), 3.83 / 0.96 / 0.24 / 0.060 us (D = 2),
// 7.19 / 1.80 / 0.45 / 0.11 us (D = 4), 3.36 / 0.84 / 0.21 / 0.052 us (the
// pair adjoint) and 1.68 / 0.42 / 0.105 / 0.026 us (the single adjoint) at
// 3.35 TB/s; the single adjoint at the LM mixer's shapes (G = 128, cpw = 8,
// 4 x 1024 or 1024 x 4 planes) moves 9.5 bytes per element, 1.49 us.  7 and 9
// operations per element are far below the f32 rate.
//
// What held the first design (a CTA per plane and direction, a thread per
// column) back:
//   1. a chain of H dependent rows per CTA, each one __syncthreads() plus the
//      latency of that row's loads, fetched only one row ahead into
//      registers: its time fit 1.3 us + 0.22 us per row, whatever the bytes;
//   2. in the training step the operands come from device memory, not the
//      L2, and a one-row prefetch cannot hide that latency (the adjoint ran
//      1.75x slower in the step than in graph replays);
//   3. each plane's CTA read its weight rows itself: cpw reads per group;
//   4. at W > 32 a row spans warps, so the neighbour exchange needed a
//      CTA-wide barrier every row;
//   5. the quad read x twice, as x stacked with its transpose by a copy
//      before the launch.
//
// Design, and what each choice does about it:
//   - One CTA per (weight group, direction), one warp per plane of the group
//     (a group of more planes than the registers allow splits over CTAs,
//     `splits`), and at least 8 warps in all: every warp issues copies.
//     Two directions in one CTA would walk opposite ends of the plane (or
//     the plane and its transpose) at every moment, so they would share no
//     staged row, and one direction per CTA multiplies the CTAs in flight
//     (128 at G = 128, cpw = 2, D = 2, on 132 SMs; 256 for D = 4).
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
//   - The quad's transposed directions read x in place (item 5).  Walk steps
//     r0..r0+nb-1 need columns r0..r0+nb-1 of x, so that direction's x region
//     of a batch is a column slab: W runs of nb items, one per row j of x, at
//     stride W in memory; as many bytes as a row batch, since the grid is
//     square.  Run j lands at word j * pitch of the region, in 4-byte copies
//     (its source alignment differs from run to run, so 16-byte copies would
//     fix the run's place modulo 16 bytes), and lane l reads run l at word
//     l * pitch + step.  The pitch is odd, so at a step the 32 lanes read 32
//     different banks in f32 (a pitch of 56 or 28 words would put 8 or 4
//     lanes on one bank).  A bf16 run starting mid-word is widened to the
//     words that cover it and read from its offset in the first one.  Every
//     region of a quad's stage is sized for the larger of a row batch and a
//     slab, so row and slab directions share one stage layout.  The walk
//     reads the slab through the same walker as the rows, with x's own step
//     (+-1 item) and slot stride (32 runs), and a run of up to 32 words takes
//     a share of a warp's copy instruction.
//   - cp.async and not TMA: a tensor map needs 16-byte row pitches and a bulk
//     copy 16-byte aligned runs, and rows of 7 or 14 f32 items (28, 56 B) or
//     planes of 49 items give neither.  A bf16 run starting at a 2-byte
//     boundary is widened to the 4-byte words that cover it; the extra 2
//     bytes read lie in the same aligned word as a byte of the operand, so in
//     mapped memory.
//   - The single adjoint at rows of more than 128 columns (1024² stage 1, W =
//     256; the LM mixer's rows, W = 1024), where one warp per plane would
//     take K = 8 or 32 columns per lane (K = 32 spills) and leave most of
//     the card idle.  On a plane taller than 16 rows, 8 warps share the
//     row in bands from the ring, exchanging their edge products under a
//     named barrier each row (1024² on an H100 80GB HBM3 at 700 W: 44 us
//     against 66 for one warp per plane and 54-92 for the first design).  On a shorter plane
//     the ring is the cost: a plane that fits is filled before its walk
//     starts, so at 4 rows of 1024 the bands ran 4.7-5.0 us against the
//     first design's 3.7-3.9, which streams each row into registers while
//     the previous one computes.  There each warp walks a window of 64 or
//     128 columns with a halo of H at each end straight from device memory,
//     four rows ahead, with no barrier at all: 3.7-3.9 us.  Column tiles per
//     CTA staged through the ring lost to the bands at every shape (6.7 us
//     at 4 rows of 1024), on the issue cost of many small copies, and
//     windows of 128 columns lost 0.2-0.3 us to those of 64 there, which
//     put two CTAs of 10 warps on a plane instead of one of 9
//     (tools/pair_launch_sweep.py; PERF.md).
//   - The launch shape (planes, warps, K, splits, batch, nbuf, slab pitch,
//     bands, direct, shared bytes) is chosen by one plain function,
//     gspn_scan.pair_launch_shape, and checked here; shared memory above 48
//     KB is opted into per launch.  The forward's D = 1 keeps the whole
//     weight group in one CTA (64 CTAs of two planes at G = 128, cpw = 2):
//     one plane per CTA (128 CTAs, each staging the group's taps again) was
//     no faster in three sweeps, within 0.25 us either way at every main
//     width (tools/pair_launch_sweep.py on an H100 at 700 W; PERF.md).  The quad and
//     the single adjoint spread a group over CTAs while whole groups would
//     leave SMs idle: at 1024² (G = 32) the quad's 128 CTAs of one plane ran
//     118 us against 182 for 64 of two, the single adjoint's 32 ran 44 us
//     against 63 for 16 (its main widths: within 0.3 us either way);
//     at the main widths its 256 CTAs fill the card as they are.  Its
//     padded pitch read within -0.14..+0.27 us of the unpadded one at N =
//     56 and 28 (8 and 4 lanes on a bank): the conflicts cost no more than
//     the sweep's spread, so a transpose of the slab in shared memory,
//     which adds a pass and a barrier, was not built.
//
// ptxas -v (CUDA 12.9, sm_90a): registers per thread at K = 1 2 4 8 16
// 32, and stack / spill stores / spill loads in bytes where not 0.  No
// static shared memory: the ring is dynamic, sized by the launch shape.
//   fwd D = 1 f32   46 64 128 146 246 255   K = 32: 152 / 240 / 308
//   fwd D = 1 bf16  44 62 128 128 237 255   K = 8: 32 / 36 / 68, K = 32: 152 / 240 / 312
//   fwd D = 2 f32   52 62 121 165 239 255   K = 32: 96 / 180 / 184
//   fwd D = 2 bf16  51 64 120 166 244 255   K = 32: 88 / 176 / 180
//   fwd D = 4 f32   52 64 106 170 255 255   K = 32: 96 / 272 / 284
//   fwd D = 4 bf16  51 64 104 168 247 255   K = 32: 96 / 268 / 280
//   bwd D = 2 f32   52 63 105 128 249 255   K = 32: 32 / 44 / 68
//   bwd D = 2 bf16  52 63 105 128 255 255   K = 8: 8 / 8 / 12, K = 32: 8 / 8 / 20
//   bwd D = 1 f32   47 62 105 128 252 255   K = 32: 40 / 64 / 80
//   bwd D = 1 bf16  49 64 106 128 255 255   K = 32: 32 / 40 / 68
//   bwd D = 1 f32, bands 62 59 110; windows 44 63 121 (K = 1 2 4)
//   bwd D = 1 bf16, bands 62 64 124; windows 48 64 127 (K = 1 2 4)
// The main widths use K = 1 and 2, without spills; D = 2 compiles to the
// registers it had as the pair's own kernel, and the single adjoint's wide
// rows take bands or windows at K <= 4, without spills.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "gspn_cell.cuh"

// The library is compiled from this file in four parts side by side
// (kernels/cuda_lib.py), each object instantiating only its own part's
// kernels: GSPN_PART = 0 the float forward and the C entry points, 1 the
// bfloat16 forward, 2 the float adjoint, 3 the bfloat16 adjoint.  The parts
// meet at the functions below, whose arguments are the C entry points' own.
// The host helpers that only the C entry points call are [[maybe_unused]] in
// the other parts.
#ifndef GSPN_PART
#error "compile with -DGSPN_PART=0..3 (kernels/cuda_lib.py)"
#endif
#define GSPN_HAS_PART(p) (GSPN_PART == (p))

namespace gspn {

struct FwdArgs {
  int ndir;
  const void *x, *wl, *wc, *wr, *lam;
  void* out;
  int G, H, W, cpw, chunk, planes, warps, k, splits, batch, nbuf, xpitch, smem;
  void* stream;
};

struct BwdArgs {
  int ndir;
  const void *dy, *wl, *wc, *wr;
  void* g;
  int G, H, W, cpw, chunk, planes, warps, k, splits, batch, nbuf, bands, direct, smem;
  void* stream;
};

cudaError_t fwd_f32(const FwdArgs& a);   // part 0
cudaError_t fwd_bf16(const FwdArgs& a);  // part 1
cudaError_t bwd_f32(const BwdArgs& a);   // part 2
cudaError_t bwd_bf16(const BwdArgs& a);  // part 3

}  // namespace gspn

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

// 4-byte words one column-slab run of `rows` items may cover: a bf16 run
// that starts mid-word takes one more half word.  The slab's pitch is at
// least this.
[[maybe_unused]] __host__ __device__ inline int slab_words(int rows, int item) {
  return (rows * item + (item < 4 ? 2 : 0) + 3) / 4;
}

// Bytes of the banded adjoint's edge products after the ring: two row
// parities of Pl and Pr per warp.
[[maybe_unused]] __host__ __device__ inline int edge_bytes(int warps) {
  return 2 * 2 * 4 * warps;
}

// Bytes of a forward region over D directions: rows, or for D = 4 the
// larger of rows and a column slab of W runs at `pitch` words, so that one
// stage layout serves the launch's row and slab directions alike.
[[maybe_unused]] __host__ __device__ inline int fwd_region_bytes(int D, int rows, int W, int item,
                                                                  int pitch) {
  const int r = region_bytes(rows, W, item);
  const int slab = (W * pitch * 4 + 15) / 16 * 16;
  return D == 4 && slab > r ? slab : r;
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

// Issue, from warp `warp` of `warps`, the copies of a column slab: `runs`
// runs of nb items, run j from src + j * stride items to word j * pitch of
// dst, in 4-byte copies.  The word holding a run's first byte goes to the
// run's first word, so its items start at (src & 3) there whatever the
// run's alignment mod 16.  A run that covers up to 32 words takes a share
// of a warp's copy instruction: lane l copies word l % wpr of run l / wpr.
template <typename T>
__device__ __forceinline__ void copy_slab(unsigned char* dst, const T* src, int runs, int stride,
                                          int nb, int pitch, int warp, int warps, int lane) {
  constexpr int item = static_cast<int>(sizeof(T));
  const uint32_t d0 = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int wpr = slab_words(nb, item);
  const int per = wpr < 32 ? 32 / wpr : 1;  // runs per warp instruction
  const int q = wpr < 32 ? lane / wpr : 0;  // this lane's run of the instruction
  if (q >= per) return;
  for (int j = warp * per + q; j < runs; j += warps * per) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src + static_cast<size_t>(j) * stride);
    const uintptr_t w0 = a & ~static_cast<uintptr_t>(3);
    const uintptr_t w1 = (a + nb * item + 3) & ~static_cast<uintptr_t>(3);
    const uint32_t base = d0 + 4u * j * pitch - static_cast<uint32_t>(w0);
    for (uintptr_t c = w0 + 4u * (lane - q * wpr); c < w1; c += 4u * 32u)
      cp_async4(base + static_cast<uint32_t>(c), c);
  }
}

// Item 0 of the run copied from src by copy_run into region.
template <typename T>
__device__ __forceinline__ const T* run_items(const unsigned char* region, const T* src) {
  return reinterpret_cast<const T*>(region + (reinterpret_cast<uintptr_t>(src) & 15));
}

// Where each CTA sits: its weight group, direction, first plane of the group
// and number of planes it computes (one warp each; the other warps only copy).
// The grid is (G_w, splits, D): group, part of the group, direction.
struct Cta {
  int gw, d, p0, np;
  __device__ Cta(int cpw, int P) {
    gw = static_cast<int>(blockIdx.x);
    d = static_cast<int>(blockIdx.z);
    p0 = static_cast<int>(blockIdx.y) * P;
    np = min(P, cpw - p0);
  }
  // The same with the part of the group given (the grid's y axis also
  // counts groups of a row's windows).
  __device__ Cta(int cpw, int P, int split) {
    gw = static_cast<int>(blockIdx.x);
    d = static_cast<int>(blockIdx.z);
    p0 = split * P;
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

// This lane's slots: column col + 32k is valid when it is below W (col is
// the lane, plus the first column of the warp's band or window in the
// single adjoint's layouts).
template <int K> struct Lanes {
  bool valid[K];
  __device__ Lanes(int col, int W) {
#pragma unroll
    for (int k = 0; k < K; ++k) valid[k] = col + 32 * k < W;
  }
  // A window that may start left of column 0 (col < 0).
  __device__ Lanes(int col, int lo, int W) {
#pragma unroll
    for (int k = 0; k < K; ++k) valid[k] = col + 32 * k >= lo && col + 32 * k < W;
  }
};

// N staged arrays' rows at this lane's column, walked through a batch: one
// pointer per array, stepped by `step` items (negative on a reverse walk),
// slot k of a row 32 k items on.  With Slab, the last array is a column slab
// instead: stepped by `xstep` items (+-1) with slot k `xk` items on (32
// runs).
template <int N, int K, typename T, bool Slab = false> struct Rows {
  const T* p[N];
  int step;
  int xstep = 0, xk = 0;
  // This lane's operands of the current row as f32, 0 in masked slots.
  __device__ __forceinline__ void load(float (&v)[N][K], const Lanes<K>& ln) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int at = Slab && i == N - 1 ? xk * k : 32 * k;
        v[i][k] = ln.valid[k] ? to_f32(p[i][at]) : 0.f;
      }
  }
  __device__ __forceinline__ void advance(bool more) {
    const int s = more ? step : 0;
#pragma unroll
    for (int i = 0; i < (Slab ? N - 1 : N); ++i) p[i] += s;
    if (Slab) p[N - 1] += more ? xstep : 0;
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
template <int N, int K, typename T, bool S, typename Row>
__device__ __forceinline__ void walk_batch(Rows<N, K, T, S>& rows, const Lanes<K>& ln, int nb,
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

// Walk nb rows straight from device memory with four rows in flight: rows
// q+1 .. q+4 load into four register sets while row q computes, so a walk
// of a few rows waits out the memory's latency about once.  The pointers
// stop at the last row, and no row is loaded twice.
template <int N, int K, typename T, typename Row>
__device__ __forceinline__ void walk_ahead(Rows<N, K, T>& rows, const Lanes<K>& ln, int nb,
                                           Row row) {
  float a[N][K], b[N][K], c[N][K], d[N][K];
  rows.load(a, ln);
  rows.advance(1 < nb);
  if (1 < nb) rows.load(b, ln);
  rows.advance(2 < nb);
  if (2 < nb) rows.load(c, ln);
  rows.advance(3 < nb);
  if (3 < nb) rows.load(d, ln);
  rows.advance(4 < nb);
  int q = 0;
  for (; q + 4 <= nb; q += 4) {  // a..d hold rows q..q+3
    row(a);
    if (q + 4 < nb) rows.load(a, ln);
    rows.advance(q + 5 < nb);
    row(b);
    if (q + 5 < nb) rows.load(b, ln);
    rows.advance(q + 6 < nb);
    row(c);
    if (q + 6 < nb) rows.load(c, ln);
    rows.advance(q + 7 < nb);
    row(d);
    if (q + 7 < nb) rows.load(d, ln);
    rows.advance(q + 8 < nb);
  }
  if (q < nb) row(a);
  if (q + 1 < nb) row(b);
  if (q + 2 < nb) row(c);
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

template <int D, int K, typename T>
__global__ void __launch_bounds__(max_threads(K))
gspn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wl, const T* __restrict__ wc,
                const T* __restrict__ wr, const T* __restrict__ lam, T* __restrict__ out, int G,
                int H, int W, int cpw, int chunk, int P, int batch, int nbuf, int xpitch) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int item = static_cast<int>(sizeof(T));
  const Cta cta(cpw, P);
  const int warps = static_cast<int>(blockDim.x) / 32;
  const int warp = static_cast<int>(threadIdx.x) / 32, lane = static_cast<int>(threadIdx.x) % 32;
  const size_t plane = static_cast<size_t>(H) * W;
  const int g0 = cta.gw * cpw + cta.p0;  // first plane of this CTA
  // Odd directions walk H-1..0; the quad's directions 2 and 3 read x
  // transposed, as column slabs.
  const bool slab = D == 4 && cta.d >= 2;
  const Walk walk{H, batch, D == 2 ? cta.d == 1 : D == 4 && (cta.d & 1)};
  // Regions of a stage: 0..2 the taps, 3+p plane p's x, 3+P+p its lam.
  const Ring ring{smem, 3 + 2 * P, fwd_region_bytes(D, batch, W, item, xpitch), nbuf,
                  (H + batch - 1) / batch};
  const size_t tap_off = (static_cast<size_t>(cta.d) * gridDim.x + cta.gw) * plane;
  const T *twl = wl + tap_off, *twc = wc + tap_off, *twr = wr + tap_off;
  const T* xg = x + static_cast<size_t>(g0) * plane;
  const T* lamg = lam + (static_cast<size_t>(cta.d) * G + g0) * plane;
  // Plane of region a; null if not this CTA's, or if it is x read as a slab.
  auto source = [&](int a) -> const T* {
    if (a < 3) return a == 0 ? twl : a == 1 ? twc : twr;
    const int p = a < 3 + P ? a - 3 : a - 3 - P;
    if (p >= cta.np || (slab && a < 3 + P)) return nullptr;
    return (a < 3 + P ? xg : lamg) + static_cast<size_t>(p) * plane;
  };
  auto issue = [&](int b) {
    if (b < ring.nbat) {
      unsigned char* stage = ring.stage(b);
      const size_t off = static_cast<size_t>(walk.row0(b)) * W;
      const int nbytes = walk.rows(b) * W * item;
      for (int a = warp; a < ring.narr; a += warps)
        if (const T* src = source(a)) copy_run(stage + a * ring.rb, src + off, nbytes, lane);
      // x's column slabs: run j of plane p holds x[j, r0 .. r0+nb-1].
      if (slab)
        for (int p = 0; p < cta.np; ++p)
          copy_slab(stage + (3 + p) * ring.rb,
                    xg + static_cast<size_t>(p) * plane + walk.row0(b), W, W, walk.rows(b),
                    xpitch, warp, warps, lane);
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
    T* o = outg + off + first;
    auto walk_rows = [&](auto chunked, auto& rows) {
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
    if constexpr (D == 4) {
      if (slab) {  // x from this plane's column slab: lane l reads run l
        const T* run = xg + static_cast<size_t>(warp) * plane +
                       static_cast<size_t>(lane) * W + walk.row0(b);
        Rows<5, K, T, true> rows{
            {run_items(stage, twl + off) + first,
             run_items(stage + ring.rb, twc + off) + first,
             run_items(stage + 2 * ring.rb, twr + off) + first,
             run_items(stage + (3 + P + warp) * ring.rb, source(3 + P + warp) + off) + first,
             reinterpret_cast<const T*>(stage + (3 + warp) * ring.rb + lane * xpitch * 4 +
                                        (reinterpret_cast<uintptr_t>(run) & 3)) +
                 (walk.reverse ? nb - 1 : 0)},
            step, walk.reverse ? -1 : 1, 32 * xpitch * 4 / item};
        walk_rows(std::false_type{}, rows);  // the quad is one-shot: no chunk
        continue;
      }
    }
    Rows<5, K, T> rows{{run_items(stage, twl + off) + first,
                        run_items(stage + ring.rb, twc + off) + first,
                        run_items(stage + 2 * ring.rb, twr + off) + first,
                        run_items(stage + (3 + P + warp) * ring.rb, source(3 + P + warp) + off) +
                            first,
                        run_items(stage + (3 + warp) * ring.rb, source(3 + warp) + off) + first},
                       step};
    // The main path has no chunk: its walk carries no reset test.
    if (chunk > 0)
      walk_rows(std::true_type{}, rows);
    else
      walk_rows(std::false_type{}, rows);
  }
}

// Wait at named barrier `id` (1..15; 0 is __syncthreads) for `threads`
// threads, whole warps; it orders their shared-memory accesses as
// __syncthreads does.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// How the single adjoint lays a plane's columns over warps.
enum Layout {
  kRows,    // one warp walks whole rows, from the ring (always for D = 2)
  kBands,   // `bands` warps share a row, each a band of 32K columns, from the ring
  kDirect,  // `bands` warps each walk a window of the row from device memory
};

// The adjoint over D = 1 or 2 directions.  Direction 0 walks H-1..0 (D = 1
// is the pair's direction 0), direction 1 walks 0..H-1.  L = kRows is the
// pair adjoint's code, which must keep its registers and time; the other
// layouts are the single adjoint's (D = 1) for rows of more than 128
// columns:
//   kBands: `bands` warps share a plane, warp b of the plane owning the
//     columns b*32K .. b*32K + 32K - 1 at K per lane; each row the edge
//     products of each band (Pl of its first column, Pr of its last) cross
//     to the neighbouring bands through shared memory under a named
//     barrier of the plane's warps, double-buffered by row parity so that
//     one barrier a row suffices.
//   kDirect (planes of few rows): window b of a plane is the 32K columns
//     from c0 = b*tile - H, tile = 32K - 2H; a CTA walks `bands` windows of
//     each of its planes, one warp each (blockIdx.y = group of windows *
//     splits + split), and stores their middle `tile` columns.  A walk of H
//     rows carries a product at most H columns, so the zeros assumed past a
//     window's ends never reach the stored columns, which get the bits of a
//     whole-row walk, and the warps need no exchange and no barrier.  Each
//     warp reads its operands from device memory four rows ahead
//     (walk_ahead), with no ring: a ring that holds the whole plane is
//     filled before the walk starts, so fill and walk add up, and on a
//     short wide plane both are a few rows of 16 KB; reading rows while
//     earlier ones are walked overlaps them and drops the fill's issue,
//     wait and barrier.
template <int D, int K, int L, typename T>
__global__ void __launch_bounds__(max_threads(K))
gspn_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ wl, const T* __restrict__ wc,
                const T* __restrict__ wr, float* __restrict__ gout, int G, int H, int W, int cpw,
                int chunk, int P, int batch, int nbuf, int bands) {
  static_assert(D == 1 || (D == 2 && L == kRows), "the layouts are the single adjoint's");
  constexpr bool Direct = L == kDirect, Banded = L == kBands;
  constexpr int item = static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  // Direct: blockIdx.y = window group * splits + split.
  const int splits = (cpw + P - 1) / P;
  const Cta cta = [&] {
    if constexpr (Direct) return Cta(cpw, P, static_cast<int>(blockIdx.y) % splits);
    else return Cta(cpw, P);
  }();
  const int warps = static_cast<int>(blockDim.x) / 32;
  const int warp = static_cast<int>(threadIdx.x) / 32, lane = static_cast<int>(threadIdx.x) % 32;
  // This warp's plane of the CTA and band (or window) of the plane, the
  // band's first column and this lane's.
  const int pw = Banded || Direct ? warp / bands : warp;
  const int band = Banded || Direct ? warp % bands : 0;
  const int window = Direct ? static_cast<int>(blockIdx.y) / splits * bands + band : 0;
  const int c0 = Direct ? window * (32 * K - 2 * H) - H : band * 32 * K;
  const int col = c0 + lane;
  const size_t plane = static_cast<size_t>(H) * W;
  const int g0 = cta.gw * cpw + cta.p0;
  const Walk walk{H, batch, D == 1 || cta.d == 0};
  // Regions of a stage: 0..2 the taps, 3+p plane p's dy.
  const Ring ring{smem, 3 + P, region_bytes(batch, W, item), nbuf, (H + batch - 1) / batch};
  // The bands' edge products after the ring: [row parity][Pl, Pr][warp].
  float* const edges =
      reinterpret_cast<float*>(smem + static_cast<size_t>(nbuf) * ring.narr * ring.rb);
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
      const int nbytes = walk.rows(b) * W * item;
      for (int a = warp; a < ring.narr; a += warps)
        if (const T* src = source(a)) copy_run(stage + a * ring.rb, src + off, nbytes, lane);
    }
    cp_commit();
  };

  const bool active = pw < cta.np;
  // The lane's valid slots (columns 0..W-1) and those it stores: all valid
  // ones, or a window's middle.
  const Lanes<K> ln = [&] {
    if constexpr (Direct) return Lanes<K>(col, 0, W);
    else return Lanes<K>(col, W);
  }();
  bool keep[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    keep[k] = ln.valid[k] && (!Direct || (col + 32 * k >= c0 + H &&
                                          col + 32 * k < c0 + 32 * K - H));
  float* outg = gout + (static_cast<size_t>(cta.d) * G + g0 + pw) * plane;
  // This lane's products of the previously walked row.
  float pl[K], pc[K], pr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) pl[k] = pc[k] = pr[k] = 0.f;
  Reset reset(chunk);
  int parity = 0;
  // Walk nb rows of `rows`, g stored at o, o stepped by `step` a row; from
  // device memory four rows ahead (kDirect), else from the ring.
  auto walk_rows = [&](auto& rows, int nb, float* o, int step) {
    auto body = [&](auto chunked) {
      auto walk_from = [&](auto&& row) {
        if constexpr (Direct)
          walk_ahead(rows, ln, nb, row);
        else
          walk_batch(rows, ln, nb, row);
      };
      walk_from([&](float (&v)[4][K]) {
        if constexpr (decltype(chunked)::value) {
          if (reset.now()) {
#pragma unroll
            for (int k = 0; k < K; ++k) pl[k] = pc[k] = pr[k] = 0.f;
          }
        }
        // Pl at column j+1 and Pr at column j-1, 0 past the row's ends (and
        // past a window's: the stored columns never see it).
        float pl_r[K], pr_l[K];
        from_right(pl, lane, pl_r);
        from_left(pr, lane, pr_l);
        float next_pl = 0.f, prev_pr = 0.f;  // across the band's ends
        if constexpr (Banded) {
          float* e = edges + parity * 2 * warps;
          if (lane == 0) e[warp] = pl[0];
          if (lane == 31) e[warps + warp] = pr[K - 1];
          bar_sync(1 + pw, 32 * bands);
          if (band + 1 < bands) next_pl = e[warp + 1];
          if (band > 0) prev_pr = e[warps + warp - 1];
          parity ^= 1;
        }
        if (lane == 31) pl_r[K - 1] = next_pl;
        if (lane == 0) pr_l[0] = prev_pr;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float gv = gspn::adjoint_cell(v[3][k], pl_r[k], pc[k], pr_l[k]);
          if (keep[k]) o[32 * k] = gv;
          // Masked slots have zero taps, so their products stay 0.
          pl[k] = __fmul_rn(v[0][k], gv); pc[k] = __fmul_rn(v[1][k], gv);
          pr[k] = __fmul_rn(v[2][k], gv);
        }
        o += step;
      });
    };
    // The main path has no chunk: its walk carries no reset test.
    if (chunk > 0)
      body(std::true_type{});
    else
      body(std::false_type{});
  };

  if constexpr (Direct) {  // rows H-1..0 straight from device memory
    if (!active || c0 + H >= W) return;  // no plane, or a window past the row
    const ptrdiff_t first = static_cast<ptrdiff_t>(H - 1) * W + col;
    Rows<4, K, T> rows{{twl + first, twc + first, twr + first, source(3 + pw) + first}, -W};
    walk_rows(rows, H, outg + first, -W);
  } else {
    for (int b = 0; b < ring.ahead(); ++b) issue(b);
    for (int b = 0; b < ring.nbat; ++b) {
      cp_wait(ring.pending(b));
      __syncthreads();  // batch b visible to every warp; batch b-1's stage free
      if (ring.refills()) issue(b + nbuf - 1);
      if (!active) continue;
      const unsigned char* stage = ring.stage(b);
      const size_t off = static_cast<size_t>(walk.row0(b)) * W;
      const int nb = walk.rows(b);
      const int first = (walk.reverse ? (nb - 1) * W : 0) + col, step = walk.reverse ? -W : W;
      Rows<4, K, T> rows{{run_items(stage, twl + off) + first,
                          run_items(stage + ring.rb, twc + off) + first,
                          run_items(stage + 2 * ring.rb, twr + off) + first,
                          run_items(stage + (3 + pw) * ring.rb, source(3 + pw) + off) + first},
                         step};
      walk_rows(rows, nb, outg + off + first, step);
    }
  }
}

// Check a launch shape against the operands and a stage of stage_bytes
// (plus `extra` bytes after the ring); cudaSuccess if it can run.  The
// single adjoint's layouts: with bands > 1 (kBands) `bands` warps share a
// plane, K <= 4 per lane, a named barrier per plane (at most 15 planes);
// direct (kDirect), a CTA walks `bands` windows of 32K columns of each of
// its planes, K <= 4, each window storing 32K - 2H >= 1 of them.
[[maybe_unused]] cudaError_t check_shape(int G, int H, int W, int cpw, int P, int warps, int k,
                                         int splits, int batch, int nbuf, int smem,
                                         long stage_bytes, int bands = 1, long extra = 0,
                                         bool direct = false) {
  const bool k_ok = k == 1 || k == 2 || k == 4 || k == 8 || k == 16 || k == 32;
  const bool bands_ok = bands == 1 || ((bands == 2 || bands == 4 || bands == 8 ||
                                        bands == 16 || bands == 32) &&
                                       k <= 4 && P <= 15);
  const bool direct_ok = k <= 4 && bands >= 1 && bands <= 32 && 32 * k > 2 * H;
  if (G < 1 || H < 1 || W < 1 || cpw < 1 || G % cpw || !k_ok ||
      !(direct ? direct_ok : bands_ok && 32 * k * bands >= W) || P < 1 ||
      warps < P * bands || 32 * warps > max_threads(k) ||
      splits < 1 || P * splits < cpw || P * (splits - 1) >= cpw || batch < 1 || nbuf < 1 ||
      nbuf > kMaxBufs || (nbuf == 1 && batch < H))
    return cudaErrorInvalidValue;
  if (nbuf * stage_bytes + extra > smem || smem > kMaxShared) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The launch shape of gspn_scan.pair_launch_shape.
struct Shape {
  int P, warps, k, splits, batch, nbuf, xpitch, smem, bands = 1, direct = 0;
};

template <int D, int K, typename T>
cudaError_t launch_fwd(const void* x, const void* wl, const void* wc, const void* wr,
                       const void* lam, void* out, int G, int H, int W, int cpw, int chunk,
                       const Shape& sh, cudaStream_t stream) {
  const cudaError_t err = opt_in(gspn_fwd_kernel<D, K, T>, sh.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(G / cpw), static_cast<unsigned>(sh.splits), D);
  gspn_fwd_kernel<D, K, T><<<grid, 32 * sh.warps, sh.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wl), static_cast<const T*>(wc),
      static_cast<const T*>(wr), static_cast<const T*>(lam), static_cast<T*>(out), G, H, W,
      cpw, chunk, sh.P, sh.batch, sh.nbuf, sh.xpitch);
  return cudaGetLastError();
}

template <int D, int K, int L, typename T>
cudaError_t launch_bwd(const void* dy, const void* wl, const void* wc, const void* wr,
                       void* g, int G, int H, int W, int cpw, int chunk, const Shape& sh,
                       cudaStream_t stream) {
  const cudaError_t err = opt_in(gspn_bwd_kernel<D, K, L, T>, sh.smem);
  if (err != cudaSuccess) return err;
  const int windows = L == kDirect ? (W + 32 * K - 2 * H - 1) / (32 * K - 2 * H) : 1;
  const int groups = (windows + sh.bands - 1) / sh.bands;
  const dim3 grid(static_cast<unsigned>(G / cpw), static_cast<unsigned>(sh.splits * groups), D);
  gspn_bwd_kernel<D, K, L, T><<<grid, 32 * sh.warps, sh.smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(wl), static_cast<const T*>(wc),
      static_cast<const T*>(wr), static_cast<float*>(g), G, H, W, cpw, chunk, sh.P, sh.batch,
      sh.nbuf, sh.bands);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t dispatch_fwd(const void* x, const void* wl, const void* wc, const void* wr,
                         const void* lam, void* out, int G, int H, int W, int cpw, int chunk,
                         const Shape& sh, cudaStream_t s) {
  switch (sh.k) {
    case 1: return launch_fwd<D, 1, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 2: return launch_fwd<D, 2, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 4: return launch_fwd<D, 4, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 8: return launch_fwd<D, 8, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 16: return launch_fwd<D, 16, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 32: return launch_fwd<D, 32, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_ndir(int ndir, const void* x, const void* wl, const void* wc,
                          const void* wr, const void* lam, void* out, int G, int H, int W,
                          int cpw, int chunk, const Shape& sh, cudaStream_t s) {
  switch (ndir) {
    case 1: return dispatch_fwd<1, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 2: return dispatch_fwd<2, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
    case 4: return dispatch_fwd<4, T>(x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, sh, s);
  }
  return cudaErrorInvalidValue;
}

// The single adjoint's banded layout L at K <= 4.
template <int L, typename T>
cudaError_t dispatch_spread(const void* dy, const void* wl, const void* wc, const void* wr,
                            void* g, int G, int H, int W, int cpw, int chunk, const Shape& sh,
                            cudaStream_t s) {
  switch (sh.k) {
    case 1: return launch_bwd<1, 1, L, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 2: return launch_bwd<1, 2, L, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 4: return launch_bwd<1, 4, L, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
  }
  return cudaErrorInvalidValue;
}

template <int D, typename T>
cudaError_t dispatch_bwd(const void* dy, const void* wl, const void* wc, const void* wr,
                         void* g, int G, int H, int W, int cpw, int chunk, const Shape& sh,
                         cudaStream_t s) {
  if constexpr (D == 1) {
    if (sh.direct)
      return dispatch_spread<kDirect, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    if (sh.bands > 1)
      return dispatch_spread<kBands, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
  }
  switch (sh.k) {
    case 1: return launch_bwd<D, 1, kRows, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 2: return launch_bwd<D, 2, kRows, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 4: return launch_bwd<D, 4, kRows, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 8: return launch_bwd<D, 8, kRows, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 16: return launch_bwd<D, 16, kRows, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
    case 32: return launch_bwd<D, 32, kRows, T>(dy, wl, wc, wr, g, G, H, W, cpw, chunk, sh, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_fwd(const gspn::FwdArgs& a) {
  const Shape sh{a.planes, a.warps, a.k, a.splits, a.batch, a.nbuf, a.xpitch, a.smem};
  return dispatch_ndir<T>(a.ndir, a.x, a.wl, a.wc, a.wr, a.lam, a.out, a.G, a.H, a.W, a.cpw,
                          a.chunk, sh, static_cast<cudaStream_t>(a.stream));
}

template <typename T>
cudaError_t run_bwd(const gspn::BwdArgs& a) {
  const Shape sh{a.planes, a.warps, a.k, a.splits, a.batch, a.nbuf, 0, a.smem, a.bands,
                 a.direct};
  const cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  return a.ndir == 1
             ? dispatch_bwd<1, T>(a.dy, a.wl, a.wc, a.wr, a.g, a.G, a.H, a.W, a.cpw, a.chunk,
                                  sh, s)
             : dispatch_bwd<2, T>(a.dy, a.wl, a.wc, a.wr, a.g, a.G, a.H, a.W, a.cpw, a.chunk,
                                  sh, s);
}

}  // namespace

#if GSPN_HAS_PART(0)
cudaError_t gspn::fwd_f32(const FwdArgs& a) { return run_fwd<float>(a); }
#endif
#if GSPN_HAS_PART(1)
cudaError_t gspn::fwd_bf16(const FwdArgs& a) { return run_fwd<__nv_bfloat16>(a); }
#endif
#if GSPN_HAS_PART(2)
cudaError_t gspn::bwd_f32(const BwdArgs& a) { return run_bwd<float>(a); }
#endif
#if GSPN_HAS_PART(3)
cudaError_t gspn::bwd_bf16(const BwdArgs& a) { return run_bwd<__nv_bfloat16>(a); }
#endif

#if GSPN_HAS_PART(0)

// The forward over ndir = 1, 2 or 4 directions (4: a square grid, no chunk).
// dtype: 0 = float32, 1 = bfloat16.  chunk <= 0: no reset.  planes, warps,
// k, splits, batch, nbuf, xpitch, smem: the launch shape of
// gspn_scan.pair_launch_shape (ring depth S = nbuf * batch rows; xpitch the
// column slab's pitch in words for ndir = 4, else 0).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gspn_fwd_launch(int ndir, int dtype, const void* x, const void* wl,
                               const void* wc, const void* wr, const void* lam, void* out,
                               int G, int H, int W, int cpw, int chunk, int planes, int warps,
                               int k, int splits, int batch, int nbuf, int xpitch, int smem,
                               void* stream) {
  const int item = dtype == 1 ? 2 : 4;
  const bool quad = ndir == 4;
  if ((ndir != 1 && ndir != 2 && !quad) || dtype < 0 || dtype > 1 ||
      (quad && (H != W || chunk > 0 || xpitch < slab_words(batch, item))) ||
      (!quad && xpitch != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      check_shape(G, H, W, cpw, planes, warps, k, splits, batch, nbuf, smem,
                  (3L + 2 * planes) * fwd_region_bytes(ndir, batch, W, item, xpitch));
  if (err != cudaSuccess) return static_cast<int>(err);
  const gspn::FwdArgs a{ndir, x, wl, wc, wr, lam, out, G, H, W, cpw, chunk, planes, warps,
                        k, splits, batch, nbuf, xpitch, smem, stream};
  return static_cast<int>(dtype == 0 ? gspn::fwd_f32(a) : gspn::fwd_bf16(a));
}

// The adjoint over ndir = 1 or 2 directions.  dtype of dy and the taps: 0 =
// float32, 1 = bfloat16; g is float32.  The other arguments as for
// gspn_fwd_launch, without xpitch and with the single adjoint's layout
// (ndir = 1): bands, the warps that share a plane (else 1), and direct, 1
// when those warps walk windows of the row from device memory with no ring
// (batch = H, nbuf = 1, no shared memory).
extern "C" int gspn_bwd_launch(int ndir, int dtype, const void* dy, const void* wl,
                               const void* wc, const void* wr, void* g, int G, int H, int W,
                               int cpw, int chunk, int planes, int warps, int k, int splits,
                               int batch, int nbuf, int bands, int direct, int smem,
                               void* stream) {
  const int item = dtype == 1 ? 2 : 4;
  if ((ndir != 1 && ndir != 2) || dtype < 0 || dtype > 1 || direct < 0 || direct > 1 ||
      (ndir == 2 && (bands != 1 || direct)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = check_shape(
      G, H, W, cpw, planes, warps, k, splits, batch, nbuf, smem,
      direct ? 0L : static_cast<long>(3 + planes) * region_bytes(batch, W, item), bands,
      bands > 1 && !direct ? edge_bytes(warps) : 0, direct);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gspn::BwdArgs a{ndir, dy, wl, wc, wr, g, G, H, W, cpw, chunk, planes, warps, k,
                        splits, batch, nbuf, bands, direct, smem, stream};
  return static_cast<int>(dtype == 0 ? gspn::bwd_f32(a) : gspn::bwd_bf16(a));
}

extern "C" const char* gspn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif  // GSPN_HAS_PART(0)
