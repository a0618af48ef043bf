// Interval-overlap range joins for Hopper (sm_90a), bound with ctypes.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/range_join.py:
//   * range_join_mask        (range_join.py:118, body _kernel, padding _pad_empty)
//   * range_join_tile_masks  (range_join.py:198, body _tile_kernel,
//                             PrefetchScalarGridSpec schedule)
//
// Both compute, for packed [N, 128] int32 boxes (lanes [0, n_attrs) hold the
// lo bounds, lanes [n_attrs, 2*n_attrs) the hi bounds):
//
//     mask[q, r] = AND_j (q.lo_j <= r.hi_j  &&  r.lo_j <= q.hi_j)
//
// and write it as uint8 0/1.  The TPU kernels wrote int32, four times the
// bytes.
//
// What bounds both on an H100 is the mask bytes they write (NQ * NR, or
// T * block_q * block_r for the tile schedule) and the compares behind
// them; the operands are rows of 2 * n_attrs lanes, a few percent of the
// bytes.  A byte costs up to 2 * n_attrs int32 compares, and the card's
// integer pipe (64 lanes a clock per SM) issues about 10 of them in the time
// HBM takes to write one byte, so at 4 attributes the compares and the
// stores are close and every instruction per byte counts.  Both kernels
// therefore run one block-tile body (block_tile below), which the mask
// kernel calls over its row-major grid of tiles and the tile kernel over the
// block tiles of each scheduled tile:
//   * a block tile is 64 q x MR r rows with MR threads (Geometry): 64 x 256
//     for the mask kernel and for the tile kernel's 256-wide tiles, 64 x 128
//     or 64 x 64 where those leave fewer of block_r's columns idle.  Each
//     thread owns a 4 q x 16 r micro-tile and packs each q row's 16 verdicts
//     into one uint4, so a warp's store writes full row segments (16-byte
//     stores where the row stride and the output are 16-byte aligned,
//     narrower ones at the alignment they have otherwise);
//   * branch-free compares: per cell, the attributes of a pass (up to four)
//     are ANDed into one predicate, one setp instruction a compare, and one
//     predicated OR sets the cell's byte (or_if_overlap, inline PTX, so the
//     compiler cannot turn the chain into selects);
//   * the operands are staged four attributes a pass, attribute-major in
//     18 KB of static shared memory whatever the width (for 256 threads),
//     with asynchronous 4-byte copies, so a pass's q and r rows are in
//     flight at once and no register holds them; two 256-thread blocks fit
//     an SM at 64 attributes as at 3, and three at 1 or 2 attributes, whose
//     passes need fewer registers; where all attributes fit one pass, a
//     block keeps its r tile staged across a strip of q tiles (the launchers
//     give a block several q tiles once the grid passes about four waves);
//     r positions are swizzled by 16-byte chunk so the eight threads of a
//     16-byte shared load hit eight distinct bank groups;
//   * between passes a warp with no live verdict stops, and a warp with at
//     most SPARSE_CAP live cells lists them and checks the remaining
//     attributes one cell a lane, straight from the packed rows
//     (sparse_finish, not inlined, so the dense passes keep its registers);
//     the block stages the next pass only while a warp still needs it
//     (__syncthreads_or), so wide joins whose first attributes kill nearly
//     every cell skip the dense work of the rest;
//   * rows past a tile's row bounds are staged as boxes that overlap nothing
//     staged and are never stored: the stores are bounds-checked, and all
//     output offsets are 64-bit (NQ * NR and T * block_q * block_r pass 2^31
//     on real frontiers).
//
// range_join_mask tiles [NQ, NR] row-major: r tiles on gridDim.x, q tiles on
// gridDim.y (which stops at 65,535, so blocks loop over q tiles).
//
// range_join_tile_masks: each block reads its tile's (tile_q[t], tile_r[t])
// from the device schedule (the TPU prefetched it into scalar memory) and
// covers block tiles of that tile's [block_q, block_r] region, with row
// bounds block_q / block_r, row stride block_r and output base
// t * block_q * block_r.  t runs on gridDim.x (y and z stop at 65,535), the
// r block tiles and the strips of q block tiles on gridDim.y, so a wave of a
// few dozen 256 x 256 tiles still fills the card (80 tiles -> 320 blocks).
// Pad rows (lo = 1, hi = 0 on the host) lie inside block_q / block_r and are
// computed and stored like any other row; the extraction filters them.
//
// A launch that covers the card a few times over runs at the mask kernel's
// cost a cell; one of a few dozen tiles (phase 4's accel-DAG waves) is held
// by its fixed costs: the launch, the schedule read, one staging round trip
// and the stores' drain.
//
// No wgmma or TMA: an integer compare has no use for the tensor cores, and
// the operands are a few percent of the bytes.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int MT = 256;         // threads of a full block
constexpr int UQ = 4;           // q rows per thread
constexpr int PASS = 4;         // attributes staged and compared per pass
constexpr int SPARSE_CAP = 256; // live cells a warp at which it checks them one a lane
constexpr int MAX_ATTRS = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t KILLED = 0x80000000u;

// A block tile of MR r rows and passes of at most MAXK attributes: MR / 16
// threads along r (16 rows each) and 16 along q (UQ rows each), so 64 q rows,
// up to MT threads (wider tiles have fewer q rows).  Passes of one or two
// attributes need fewer registers, so three full blocks fit an SM where
// four-attribute passes fit two.
template <int MR_, int MAXK_>
struct Geometry {
  static constexpr int MR = MR_, MAXK = MAXK_;
  static constexpr int NT = MR < MT ? MR : MT;  // threads
  static constexpr int RT = MR / 16;            // threads along r
  static constexpr int MQ = NT / RT * UQ;       // q rows
  static constexpr int BLOCKS = (MAXK <= 2 ? 3 : 2) * MT / NT;  // blocks an SM
  static_assert(MR % 64 == 0, "whole warps");
};

// One pass's operands, attribute-major (r rows swizzled by rpos), and each
// warp's list of live cells for sparse_finish: 18 KB for a full block.
template <class G>
struct BlockStage {
  int qlo[PASS][G::MQ];
  int qhi[PASS][G::MQ];
  int rlo[PASS][G::MR];
  int rhi[PASS][G::MR];
  uint32_t list[G::NT / 32][SPARSE_CAP];
};

// Position of r row ``r`` in its shared attribute row.  A thread reads its
// 16 rows as four 16-byte chunks; chunk c moves to c ^ ((c >> 3) & 7),
// which keeps it among the same eight chunks and sends the eight threads of
// one 16-byte load to eight distinct bank groups.
__device__ __forceinline__ int rpos(int r) {
  const int c = r >> 2;
  return ((c ^ ((c >> 3) & 7)) << 2) | (r & 3);
}

__device__ __forceinline__ void unpack4(const int4 v, int* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Start staging attributes [c, c + k) of ``ROWS`` packed rows from
// ``base`` (lo lanes c.., hi lanes n_attrs + c..) into lo/hi[attribute][row]
// with asynchronous 4-byte copies, so the q and r rows of a pass are all in
// flight at once and no register holds them (stage_wait ends them); rows at
// or past n_rows get lo = INT32_MAX, hi = INT32_MIN and are never stored.
template <int NT, bool SWIZZLE, int ROWS>
__device__ __forceinline__ void stage_pass(const int32_t* __restrict__ base, int64_t n_rows,
                                           int n_attrs, int c, int k,
                                           int (&lo)[PASS][ROWS], int (&hi)[PASS][ROWS]) {
  for (int e = threadIdx.x; e < 2 * ROWS; e += NT) {
    const int row = e >> 1;
    const bool is_hi = e & 1;
    const int pos = SWIZZLE ? rpos(row) : row;
    int* dst = is_hi ? &hi[0][pos] : &lo[0][pos];
    if (row < n_rows) {
      const int32_t* p = base + (int64_t)row * LANES + (is_hi ? n_attrs + c : c);
#pragma unroll
      for (int u = 0; u < PASS; ++u)
        if (u < k) __pipeline_memcpy_async(dst + u * ROWS, p + u, sizeof(int));
    } else {
#pragma unroll
      for (int u = 0; u < PASS; ++u)
        if (u < k) dst[u * ROWS] = is_hi ? INT32_MIN : INT32_MAX;
    }
  }
}

// Wait for this thread's staging copies, then for the block's.
__device__ __forceinline__ void stage_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// word | bit where the q and r boxes overlap in all K attributes, else word:
// one predicate ANDed through the 2K compares (setp ... .and, one integer
// instruction each) and one predicated OR, so a cell of a K-attribute pass
// costs 2K + 1 instructions.
template <int K>
__device__ __forceinline__ uint32_t or_if_overlap(uint32_t word, uint32_t bit,
                                                  const int* ql, const int* qh,
                                                  const int* rl, const int* rh) {
  static_assert(K >= 1 && K <= 4, "a pass has 1 to 4 attributes");
#define RJ_OPEN "{\n\t.reg .pred p;\n\tsetp.le.s32 p, %1, %2;\n\tsetp.le.and.s32 p, %3, %4, p;\n\t"
#define RJ_AND(x, y) "setp.le.and.s32 p, %" #x ", %" #y ", p;\n\t"
#define RJ_CLOSE(b) "@p or.b32 %0, %0, %" #b ";\n\t}"
  if constexpr (K == 1) {
    asm(RJ_OPEN RJ_CLOSE(5)
        : "+r"(word) : "r"(ql[0]), "r"(rh[0]), "r"(rl[0]), "r"(qh[0]), "r"(bit));
  } else if constexpr (K == 2) {
    asm(RJ_OPEN RJ_AND(5, 6) RJ_AND(7, 8) RJ_CLOSE(9)
        : "+r"(word)
        : "r"(ql[0]), "r"(rh[0]), "r"(rl[0]), "r"(qh[0]),
          "r"(ql[1]), "r"(rh[1]), "r"(rl[1]), "r"(qh[1]), "r"(bit));
  } else if constexpr (K == 3) {
    asm(RJ_OPEN RJ_AND(5, 6) RJ_AND(7, 8) RJ_AND(9, 10) RJ_AND(11, 12) RJ_CLOSE(13)
        : "+r"(word)
        : "r"(ql[0]), "r"(rh[0]), "r"(rl[0]), "r"(qh[0]),
          "r"(ql[1]), "r"(rh[1]), "r"(rl[1]), "r"(qh[1]),
          "r"(ql[2]), "r"(rh[2]), "r"(rl[2]), "r"(qh[2]), "r"(bit));
  } else {
    asm(RJ_OPEN RJ_AND(5, 6) RJ_AND(7, 8) RJ_AND(9, 10) RJ_AND(11, 12)
        RJ_AND(13, 14) RJ_AND(15, 16) RJ_CLOSE(17)
        : "+r"(word)
        : "r"(ql[0]), "r"(rh[0]), "r"(rl[0]), "r"(qh[0]),
          "r"(ql[1]), "r"(rh[1]), "r"(rl[1]), "r"(qh[1]),
          "r"(ql[2]), "r"(rh[2]), "r"(rl[2]), "r"(qh[2]),
          "r"(ql[3]), "r"(rh[3]), "r"(rl[3]), "r"(qh[3]), "r"(bit));
  }
#undef RJ_OPEN
#undef RJ_AND
#undef RJ_CLOSE
  return word;
}

// One pass over the K staged attributes, ANDed into w: byte j of w[i][g] is
// the verdict (0 or 1) of q row tq*4 + i against r row tr*16 + 4*g + j.
template <int K, class G>
__device__ __forceinline__ void dense_pass(const BlockStage<G>& st, int tq, int tr,
                                           uint32_t (&w)[UQ][4]) {
  int qlo[UQ][K], qhi[UQ][K];  // [q row][attribute]
#pragma unroll
  for (int a = 0; a < K; ++a) {
    int lo[4], hi[4];
    unpack4(*reinterpret_cast<const int4*>(&st.qlo[a][tq * UQ]), lo);
    unpack4(*reinterpret_cast<const int4*>(&st.qhi[a][tq * UQ]), hi);
#pragma unroll
    for (int i = 0; i < UQ; ++i) {
      qlo[i][a] = lo[i];
      qhi[i][a] = hi[i];
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int pos = rpos(tr * 16 + 4 * g);
    int rlo[4][K], rhi[4][K];  // [r row][attribute]
#pragma unroll
    for (int a = 0; a < K; ++a) {
      int lo[4], hi[4];
      unpack4(*reinterpret_cast<const int4*>(&st.rlo[a][pos]), lo);
      unpack4(*reinterpret_cast<const int4*>(&st.rhi[a][pos]), hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rlo[j][a] = lo[j];
        rhi[j][a] = hi[j];
      }
    }
#pragma unroll
    for (int i = 0; i < UQ; ++i) {
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word = or_if_overlap<K>(word, 1u << (8 * j), qlo[i], qhi[i], rlo[j], rhi[j]);
      w[i][g] &= word;
    }
  }
}

// A pass of k staged attributes, k <= G::MAXK.
template <class G>
__device__ __forceinline__ void dense_pass_k(const BlockStage<G>& st, int k, int tq, int tr,
                                             uint32_t (&w)[UQ][4]) {
  if (G::MAXK == 1 || k == 1) dense_pass<1>(st, tq, tr, w);
  else if (G::MAXK == 2 || k == 2) dense_pass<2>(st, tq, tr, w);
  else if (k == 3) dense_pass<3>(st, tq, tr, w);
  else dense_pass<4>(st, tq, tr, w);
}

// Attributes [a1, n_attrs) for the warp's live cells only (at most
// SPARSE_CAP), one lane a cell, read straight from the packed rows of the
// block tile (q, r: its first rows; nq, nr: its row bounds): the cells are
// listed in ``list`` (entry: owner lane << 16 | (i * 4 + g) << 8 | verdict
// bit), checked in parallel, and cleared in their owners' w where one
// fails.  Every lane of the warp calls this.  Not inlined: it runs only in
// wide joins, and inlined its registers made the dense passes spill.
template <class G>
__device__ __noinline__ void sparse_finish(
    const int32_t* __restrict__ q, int64_t nq, const int32_t* __restrict__ r, int64_t nr,
    int n_attrs, int a1, uint32_t (&w)[UQ][4], int live, uint32_t* list) {
  constexpr int RT = G::RT;
  const int lane = threadIdx.x & 31;
  int end = live;  // inclusive prefix sum of live over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, end, d);
    if (lane >= d) end += v;
  }
  const int total = __shfl_sync(FULL, end, 31);
  const int first = end - live;
  int k = first;
#pragma unroll
  for (int i = 0; i < UQ; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      for (uint32_t m = w[i][g]; m; m &= m - 1u)
        list[k++] = (uint32_t)lane << 16 | (uint32_t)(i * 4 + g) << 8 | (__ffs(m) - 1);
  __syncwarp();
  const int warp0 = threadIdx.x & ~31;
  for (int e = lane; e < total; e += 32) {
    const uint32_t entry = list[e];
    const int t = warp0 + (int)(entry >> 16);  // the owner's thread index
    const int ig = (entry >> 8) & 0xff, bit = entry & 0xff;
    const int qi = (t / RT) * UQ + (ig >> 2);
    const int ri = (t % RT) * 16 + 4 * (ig & 3) + (bit >> 3);
    bool ok = qi < nq && ri < nr;  // past the bounds: never stored, never read
    if (ok) {
      const int32_t* qp = q + (int64_t)qi * LANES;
      const int32_t* rp = r + (int64_t)ri * LANES;
      for (int a = a1; a < n_attrs && ok; a += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int b = a + u < n_attrs ? a + u : a;  // past the end: repeat a
          ok &= (__ldg(qp + b) <= __ldg(rp + n_attrs + b)) & (__ldg(rp + b) <= __ldg(qp + n_attrs + b));
        }
      }
    }
    if (!ok) list[e] = entry | KILLED;
  }
  __syncwarp();
  k = first;
#pragma unroll
  for (int i = 0; i < UQ; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      for (uint32_t m = w[i][g]; m; m &= m - 1u)
        if (list[k++] & KILLED) w[i][g] &= ~(1u << (__ffs(m) - 1));
  __syncwarp();  // the list is free again
}

// Store row i's 16 verdicts (w[0..3]) at o, ``n`` of them in range, with
// stores of ``align`` bytes (the alignment o has).
__device__ __forceinline__ void store_row(uint8_t* o, const uint32_t (&w)[4], int64_t n,
                                          int align) {
  if (n >= 16) {
    switch (align) {
      case 16:
        *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
        return;
      case 8:
        reinterpret_cast<uint2*>(o)[0] = make_uint2(w[0], w[1]);
        reinterpret_cast<uint2*>(o)[1] = make_uint2(w[2], w[3]);
        return;
      case 4:
#pragma unroll
        for (int k = 0; k < 4; ++k) reinterpret_cast<uint32_t*>(o)[k] = w[k];
        return;
      case 2:
#pragma unroll
        for (int k = 0; k < 8; ++k)
          reinterpret_cast<uint16_t*>(o)[k] = (uint16_t)(w[k >> 1] >> (16 * (k & 1)));
        return;
      default:
        break;
    }
  }
  const int m = n < 16 ? (int)n : 16;
  for (int b = 0; b < m; ++b) o[b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
}

// The block tile whose first q and r rows are q and r, with nq and nr rows
// in bounds from there (more than the tile's rows is fine), into out (the
// verdict of its first cell) with rows ``stride`` bytes apart and stores of
// ``align`` bytes.  ``r_staged`` says the r tile of the last call is still
// staged and is the same; it is set where the next call may rely on that.
// Every thread of the block calls this.
template <class G>
__device__ __forceinline__ void block_tile(const int32_t* __restrict__ q, int64_t nq,
                                           const int32_t* __restrict__ r, int64_t nr,
                                           uint8_t* __restrict__ out, int64_t stride, int align,
                                           int n_attrs, BlockStage<G>& st, bool& r_staged) {
  constexpr int RT = G::RT, NT = G::NT;
  uint32_t* list = st.list[threadIdx.x >> 5];
  const int tq = threadIdx.x / RT, tr = threadIdx.x % RT;
  const int k0 = min(PASS, n_attrs);
  __syncthreads();  // the last tile is done with the staged operands
  stage_pass<NT, false>(q, nq, n_attrs, 0, k0, st.qlo, st.qhi);
  if (!r_staged) stage_pass<NT, true>(r, nr, n_attrs, 0, k0, st.rlo, st.rhi);
  r_staged = n_attrs <= PASS;
  stage_wait();
  uint32_t w[UQ][4];
#pragma unroll
  for (int i = 0; i < UQ; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) w[i][g] = 0x01010101u;
  if (k0) dense_pass_k(st, k0, tq, tr, w);
  // later passes: a warp whose cells are all dead stops; one with at most
  // SPARSE_CAP live cells finishes them in sparse_finish; the block stages
  // the next pass while any warp still needs it
  bool done = false;
  for (int a0 = k0; a0 < n_attrs; a0 += PASS) {
    if (!done) {
      int live = 0;
#pragma unroll
      for (int i = 0; i < UQ; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) live += __popc(w[i][g]);
      const int warp_live = __reduce_add_sync(FULL, live);
      if (warp_live <= SPARSE_CAP) {
        if (warp_live) sparse_finish<G>(q, nq, r, nr, n_attrs, a0, w, live, list);
        done = true;
      }
    }
    if (!__syncthreads_or(!done)) break;
    const int k = min(PASS, n_attrs - a0);
    stage_pass<NT, false>(q, nq, n_attrs, a0, k, st.qlo, st.qhi);
    stage_pass<NT, true>(r, nr, n_attrs, a0, k, st.rlo, st.rhi);
    stage_wait();
    if (!done) dense_pass_k(st, k, tq, tr, w);
  }
  const int rr = tr * 16;
  if (rr < nr) {
#pragma unroll
    for (int i = 0; i < UQ; ++i) {
      const int qi = tq * UQ + i;
      if (qi < nq) store_row(out + qi * stride + rr, w[i], nr - rr, align);
    }
  }
}

// ----------------------------------------------------------------------------
// range_join_mask
// ----------------------------------------------------------------------------
// The mask kernel's block tile: 64 q x 256 r.
template <int MAXK>
using MaskGeometry = Geometry<256, MAXK>;

// Block (x, y) takes r tile x and, in turn, q tiles [y * per, y * per + per),
// then the same span gridDim.y * per further on, and so on.  Where all
// attributes fit one pass, the r tile is staged once for all of them.
template <class G>
__global__ void __launch_bounds__(G::NT, G::BLOCKS)
range_join_mask_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ r,
                       uint8_t* __restrict__ out, int64_t nq, int64_t nr,
                       int n_attrs, int64_t n_qt, int64_t per, int align) {
  constexpr int MQ = G::MQ;
  __shared__ __align__(16) BlockStage<G> st;
  const int64_t r0 = (int64_t)blockIdx.x * G::MR;
  bool r_staged = false;
  for (int64_t span = (int64_t)blockIdx.y * per; span < n_qt; span += (int64_t)gridDim.y * per) {
    const int64_t span_end = span + per < n_qt ? span + per : n_qt;
    for (int64_t qt = span; qt < span_end; ++qt) {
      const int64_t q0 = qt * MQ;
      block_tile<G>(q + q0 * LANES, nq - q0, r + r0 * LANES, nr - r0, out + q0 * nr + r0, nr,
                    align, n_attrs, st, r_staged);
    }
  }
}

// ----------------------------------------------------------------------------
// range_join_tile_masks
// ----------------------------------------------------------------------------
// Block (t, y) reads tile t's schedule entry and takes its r sub-tile
// y % n_sr and, in turn, its q sub-tiles [s * per, s * per + per) for
// s = y / n_sr; the r sub-tile stays staged across them where all
// attributes fit one pass.
template <class G>
__global__ void __launch_bounds__(G::NT, G::BLOCKS)
range_join_tile_masks_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ r,
                             const int32_t* __restrict__ tile_q,
                             const int32_t* __restrict__ tile_r,
                             uint8_t* __restrict__ out, int bq, int br, int n_attrs,
                             int n_sr, int per, int align) {
  constexpr int MQ = G::MQ;
  __shared__ __align__(16) BlockStage<G> st;
  const int64_t t = blockIdx.x;
  const int sr = (int)(blockIdx.y % n_sr), strip = (int)(blockIdx.y / n_sr);
  const int64_t q0 = (int64_t)__ldg(tile_q + t) * bq;
  const int64_t r0 = (int64_t)__ldg(tile_r + t) * br + (int64_t)sr * G::MR;
  uint8_t* o = out + t * bq * br + (int64_t)sr * G::MR;
  const int sq_end = min((bq + MQ - 1) / MQ, strip * per + per);
  bool r_staged = false;
  for (int sq = strip * per; sq < sq_end; ++sq) {
    const int64_t qs = (int64_t)sq * MQ;
    block_tile<G>(q + (q0 + qs) * LANES, bq - qs, r + r0 * LANES, br - (int64_t)sr * G::MR,
                  o + qs * br, br, align, n_attrs, st, r_staged);
  }
}

// The widest store every thread's 16 bytes allow: a row starts at a multiple
// of ``stride`` past out, and a thread's bytes at a multiple of 16 past it.
int store_align(long long stride, const void* out) {
  const unsigned long long bits = (unsigned long long)stride | (uintptr_t)out | 16u;
  return (int)(bits & (~bits + 1u));
}

// Block tiles of geometry G a block takes in turn: one, unless ``tiles`` of
// them would run more than about four waves of the card; then as many as
// keep it to that, at most ``most``.
template <class G>
int strip_length(long long tiles, long long most, long long* per) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long p = tiles / (4LL * G::BLOCKS * sms);
  *per = p < 1 ? 1 : (p > most ? most : p);
  return 0;
}

template <class G>
int launch_mask(const int32_t* q, const int32_t* r, uint8_t* out, long long nq, long long nr,
                int n_attrs, cudaStream_t stream) {
  const long long n_qt = (nq + G::MQ - 1) / G::MQ;
  const long long n_rt = (nr + G::MR - 1) / G::MR;
  if (n_rt > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  long long per = 1;
  const int err = strip_length<G>(n_qt * n_rt, n_qt, &per);
  if (err) return err;
  const long long n_y = (n_qt + per - 1) / per;
  dim3 grid((unsigned)n_rt, (unsigned)(n_y < 65535 ? n_y : 65535));
  range_join_mask_kernel<G><<<grid, G::NT, 0, stream>>>(
      q, r, out, nq, nr, n_attrs, n_qt, per, store_align(nr, out));
  return (int)cudaGetLastError();
}

template <class G>
int launch_tile_masks(const int32_t* q, const int32_t* r, const int32_t* tile_q,
                      const int32_t* tile_r, uint8_t* out, long long n_tiles, int bq, int br,
                      int n_attrs, cudaStream_t stream) {
  const long long n_sq = (bq + G::MQ - 1) / G::MQ;
  const long long n_sr = (br + G::MR - 1) / G::MR;
  long long per = 1;
  const int err = strip_length<G>(n_tiles * n_sq * n_sr, n_sq, &per);
  if (err) return err;
  const long long n_y = n_sr * ((n_sq + per - 1) / per);
  if (n_y > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)n_tiles, (unsigned)n_y);
  range_join_tile_masks_kernel<G><<<grid, G::NT, 0, stream>>>(
      q, r, tile_q, tile_r, out, bq, br, n_attrs, (int)n_sr, (int)per, store_align(br, out));
  return (int)cudaGetLastError();
}

template <int MR>
int launch_tile_masks_at(const int32_t* q, const int32_t* r, const int32_t* tile_q,
                         const int32_t* tile_r, uint8_t* out, long long n_tiles, int bq, int br,
                         int n_attrs, cudaStream_t stream) {
  return (n_attrs <= 2 ? launch_tile_masks<Geometry<MR, 2>>
                       : launch_tile_masks<Geometry<MR, PASS>>)(
      q, r, tile_q, tile_r, out, n_tiles, bq, br, n_attrs, stream);
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after its launch (0 when
// nothing was launched because a dimension is 0), or the error that refused
// its arguments before a launch.

int rj_range_join_mask(const void* q, const void* r, void* out, long long nq,
                       long long nr, int n_attrs, void* stream) {
  if (nq <= 0 || nr <= 0) return 0;
  if (n_attrs < 1 || n_attrs > MAX_ATTRS) return (int)cudaErrorInvalidValue;
  return (n_attrs <= 2 ? launch_mask<MaskGeometry<2>> : launch_mask<MaskGeometry<PASS>>)(
      (const int32_t*)q, (const int32_t*)r, (uint8_t*)out, nq, nr, n_attrs,
      (cudaStream_t)stream);
}

// A scheduled tile is covered by block tiles of 64 q rows and 256, 128 or
// 64 r rows: the widest that leaves the fewest of block_r's columns idle.
int rj_range_join_tile_masks(const void* q, const void* r, const void* tile_q,
                             const void* tile_r, void* out, long long n_tiles,
                             int bq, int br, int n_attrs, void* stream) {
  if (n_tiles <= 0 || bq <= 0 || br <= 0) return 0;
  if (n_attrs < 0 || n_attrs > MAX_ATTRS) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const auto padded = [br](int w) { return (br + w - 1) / w * w; };
  int mr = 256;
  if (padded(128) < padded(mr)) mr = 128;
  if (padded(64) < padded(mr)) mr = 64;
  const auto* qp = (const int32_t*)q;
  const auto* rp = (const int32_t*)r;
  const auto* tq = (const int32_t*)tile_q;
  const auto* tr = (const int32_t*)tile_r;
  auto* o = (uint8_t*)out;
  const auto s = (cudaStream_t)stream;
  switch (mr) {
    case 256: return launch_tile_masks_at<256>(qp, rp, tq, tr, o, n_tiles, bq, br, n_attrs, s);
    case 128: return launch_tile_masks_at<128>(qp, rp, tq, tr, o, n_tiles, bq, br, n_attrs, s);
    default: return launch_tile_masks_at<64>(qp, rp, tq, tr, o, n_tiles, bq, br, n_attrs, s);
  }
}

const char* rj_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
