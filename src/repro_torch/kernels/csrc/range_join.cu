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
// range_join_mask: what bounds it on an H100 is the NQ * NR mask bytes it
// writes; the operands are (NQ + NR) rows of 2 * n_attrs lanes, a few
// percent of that.  A byte costs up to 2 * n_attrs int32 compares, and the
// card's integer pipe (64 lanes a clock per SM) issues about 10 of them in
// the time HBM takes to write one byte, so at 4 attributes the compares and
// the stores are close and every instruction per byte counts.  The design:
//   * a 256-thread block computes a 64 q x 256 r tile; each thread owns a
//     4 q x 16 r micro-tile and packs each q row's 16 verdicts into one
//     uint4, so a warp's store writes two 256-byte row segments (16-byte
//     stores where NR and the output are 16-byte aligned, narrower ones at
//     the alignment they have otherwise);
//   * branch-free compares: per cell, the attributes of a pass (up to four)
//     are ANDed into one predicate, one setp instruction a compare, and one
//     predicated OR sets the cell's byte (or_if_overlap, inline PTX, so the
//     compiler cannot turn the chain into selects);
//   * the operands are staged four attributes a pass, attribute-major in
//     18 KB of static shared memory whatever the width, so two blocks fit an
//     SM at 64 attributes as at 1; where all attributes fit one pass, a
//     block keeps its r tile staged across a strip of q tiles (the launcher
//     gives a block several q tiles once the grid passes about four waves);
//     r positions are swizzled by 16-byte chunk so the eight threads of a
//     16-byte shared load hit eight distinct bank groups;
//   * between passes a warp with no live verdict stops, and a warp with at
//     most SPARSE_CAP live cells lists them and checks the remaining
//     attributes one cell a lane, straight from the packed rows
//     (sparse_finish); the block stages the next pass only while a warp
//     still needs it (__syncthreads_or), so wide joins whose first
//     attributes kill nearly every cell skip the dense work of the rest;
//   * rows past nq / nr are staged as boxes no box overlaps and never
//     stored: the stores are bounds-checked, and all output offsets are
//     64-bit (NQ * NR passes 2^31 on real frontiers).  q tiles loop over
//     gridDim.y, which stops at 65,535.
//
// range_join_tile_masks keeps its first design (eval_tile below): one thread
// owns one r row and 32 q rows, with the 32 verdicts as bits of a register;
// attributes are staged 8 at a time; a block-wide __syncthreads_or ends the
// attribute loop.  It reads its schedule (tile_q[t], tile_r[t]) from device
// int32 arrays where the TPU prefetched it into scalar memory; the tile
// index t runs on gridDim.x because gridDim.y and z stop at 65,535.
//
// No wgmma or TMA: an integer compare has no use for the tensor cores, and
// the operands are a few percent of the bytes, read with plain loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;

// ----------------------------------------------------------------------------
// range_join_mask
// ----------------------------------------------------------------------------
constexpr int MQ = 64;          // q rows per block tile
constexpr int MR = 256;         // r rows per block tile
constexpr int MT = 256;         // threads: 16 along q x 16 along r
constexpr int UQ = 4;           // q rows per thread
constexpr int PASS = 4;         // attributes staged and compared per pass
constexpr int SPARSE_CAP = 256; // live cells a warp at which it checks them one a lane
constexpr int MAX_ATTRS = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t KILLED = 0x80000000u;

// One pass's operands, attribute-major (r rows swizzled by rpos), and each
// warp's list of live cells for sparse_finish: 18 KB.
struct MaskStage {
  int qlo[PASS][MQ];
  int qhi[PASS][MQ];
  int rlo[PASS][MR];
  int rhi[PASS][MR];
  uint32_t list[MT / 32][SPARSE_CAP];
};

// Position of r row ``r`` (0..MR-1) in its shared attribute row.  A thread
// reads its 16 rows as four 16-byte chunks; chunk c moves to
// c ^ ((c >> 3) & 7), which keeps it among the same eight chunks and sends
// the eight threads of one 16-byte load to eight distinct bank groups.
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

// Stage attributes [c, c + k) of ``rows`` packed rows from row0 (lo lanes
// c.., hi lanes n_attrs + c..) into lo/hi[attribute][row]; rows past
// n_rows get lo = INT32_MAX, hi = INT32_MIN, a box no box overlaps.
template <int ROWS>
__device__ __forceinline__ void stage_pass(const int32_t* __restrict__ base, int64_t row0,
                                           int64_t n_rows, int n_attrs, int c, int k,
                                           int (&lo)[PASS][ROWS], int (&hi)[PASS][ROWS]) {
  for (int e = threadIdx.x; e < 2 * ROWS; e += MT) {
    const int row = e >> 1;
    const bool is_hi = e & 1;
    const int64_t g = row0 + row;
    int v[PASS];
    if (g < n_rows) {
      const int32_t* p = base + g * LANES + (is_hi ? n_attrs + c : c);
#pragma unroll
      for (int u = 0; u < PASS; ++u) v[u] = u < k ? __ldg(p + u) : 0;
    } else {
#pragma unroll
      for (int u = 0; u < PASS; ++u) v[u] = is_hi ? INT32_MIN : INT32_MAX;
    }
    const int pos = ROWS == MR ? rpos(row) : row;
#pragma unroll
    for (int u = 0; u < PASS; ++u)
      if (u < k) (is_hi ? hi : lo)[u][pos] = v[u];
  }
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
template <int K>
__device__ __forceinline__ void dense_pass(const MaskStage& st, int tq, int tr,
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

__device__ __forceinline__ void dense_pass_k(const MaskStage& st, int k, int tq, int tr,
                                             uint32_t (&w)[UQ][4]) {
  switch (k) {
    case 1: dense_pass<1>(st, tq, tr, w); break;
    case 2: dense_pass<2>(st, tq, tr, w); break;
    case 3: dense_pass<3>(st, tq, tr, w); break;
    default: dense_pass<4>(st, tq, tr, w); break;
  }
}

// Attributes [a1, n_attrs) for the warp's live cells only (at most
// SPARSE_CAP), one lane a cell, read straight from the packed rows: the
// cells are listed in ``list`` (entry: owner lane << 16 | (i * 4 + g) << 8 |
// verdict bit), checked in parallel, and cleared in their owners' w where
// one fails.  Every lane of the warp calls this.
__device__ __forceinline__ void sparse_finish(
    const int32_t* __restrict__ q, const int32_t* __restrict__ r, int64_t q0, int64_t nq,
    int64_t r0, int64_t nr, int n_attrs, int a1, uint32_t (&w)[UQ][4], int live,
    uint32_t* list) {
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
    const int64_t qi = q0 + (t >> 4) * UQ + (ig >> 2);
    const int64_t ri = r0 + (t & 15) * 16 + 4 * (ig & 3) + (bit >> 3);
    bool ok = qi < nq && ri < nr;  // a padding row: never stored, never read
    if (ok) {
      const int32_t* qp = q + qi * LANES;
      const int32_t* rp = r + ri * LANES;
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

// Block (x, y) takes r tile x and, in turn, q tiles [y * per, y * per + per),
// then the same span gridDim.y * per further on, and so on.  Where all
// attributes fit one pass, the r tile is staged once for all of them.
__global__ void __launch_bounds__(MT, 2)
range_join_mask_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ r,
                       uint8_t* __restrict__ out, int64_t nq, int64_t nr,
                       int n_attrs, int64_t n_qt, int64_t per, int align) {
  __shared__ __align__(16) MaskStage st;
  uint32_t* list = st.list[threadIdx.x >> 5];
  const int tq = threadIdx.x >> 4, tr = threadIdx.x & 15;
  const int64_t r0 = (int64_t)blockIdx.x * MR;
  const int64_t rr = r0 + tr * 16;
  const int k0 = min(PASS, n_attrs);
  bool r_staged = false;
  for (int64_t span = (int64_t)blockIdx.y * per; span < n_qt; span += (int64_t)gridDim.y * per) {
    const int64_t span_end = span + per < n_qt ? span + per : n_qt;
    for (int64_t qt = span; qt < span_end; ++qt) {
      const int64_t q0 = qt * MQ;
      __syncthreads();  // the last tile is done with the staged operands
      stage_pass<MQ>(q, q0, nq, n_attrs, 0, k0, st.qlo, st.qhi);
      if (!r_staged) stage_pass<MR>(r, r0, nr, n_attrs, 0, k0, st.rlo, st.rhi);
      r_staged = n_attrs <= PASS;
      __syncthreads();
      uint32_t w[UQ][4];
#pragma unroll
      for (int i = 0; i < UQ; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) w[i][g] = 0x01010101u;
      dense_pass_k(st, k0, tq, tr, w);
      // later passes: a warp whose cells are all dead stops; one with at
      // most SPARSE_CAP live cells finishes them in sparse_finish; the block
      // stages the next pass while any warp still needs it
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
            if (warp_live) sparse_finish(q, r, q0, nq, r0, nr, n_attrs, a0, w, live, list);
            done = true;
          }
        }
        if (!__syncthreads_or(!done)) break;
        const int k = min(PASS, n_attrs - a0);
        stage_pass<MQ>(q, q0, nq, n_attrs, a0, k, st.qlo, st.qhi);
        stage_pass<MR>(r, r0, nr, n_attrs, a0, k, st.rlo, st.rhi);
        __syncthreads();
        if (!done) dense_pass_k(st, k, tq, tr, w);
      }
      if (rr < nr) {
#pragma unroll
        for (int i = 0; i < UQ; ++i) {
          const int64_t qi = q0 + tq * UQ + i;
          if (qi < nq) store_row(out + qi * nr + rr, w[i], nr - rr, align);
        }
      }
    }
  }
}

// ----------------------------------------------------------------------------
// range_join_tile_masks
// ----------------------------------------------------------------------------
constexpr int TQ = 32;     // q rows per block: one bit each of a 32-bit mask
constexpr int TR = 128;    // r rows per block: one per thread
constexpr int CHUNK = 8;   // attributes staged in shared memory per pass

struct Stage {
  int qlo[CHUNK][TQ];
  int qhi[CHUNK][TQ];
  int rlo[CHUNK][TR];
  int rhi[CHUNK][TR];
};

// Evaluate one [nq x nr] output tile (nq <= TQ, nr <= TR).  q and r point at
// the tile's first packed rows; out at its first byte, with rows
// out_stride bytes apart.  Every thread of the block must call this.
__device__ __forceinline__ void eval_tile(
    const int32_t* __restrict__ q, int nq,
    const int32_t* __restrict__ r, int nr,
    int n_attrs, uint8_t* __restrict__ out, int64_t out_stride,
    Stage& s) {
  const int tx = threadIdx.x;
  uint32_t alive = 0u;
  if (tx < nr) alive = (nq >= 32) ? 0xffffffffu : ((1u << nq) - 1u);
  for (int c = 0; c < n_attrs; c += CHUNK) {
    const int k = min(CHUNK, n_attrs - c);
    for (int e = tx; e < TQ * k; e += TR) {
      const int row = e / k, a = e - (e / k) * k;
      int lo = 1, hi = 0;  // rows past nq carry no live bit; keep them empty
      if (row < nq) {
        const int32_t* p = q + (int64_t)row * LANES;
        lo = p[c + a];
        hi = p[n_attrs + c + a];
      }
      s.qlo[a][row] = lo;
      s.qhi[a][row] = hi;
    }
    for (int e = tx; e < TR * k; e += TR) {
      const int row = e / k, a = e - (e / k) * k;
      int lo = 1, hi = 0;
      if (row < nr) {
        const int32_t* p = r + (int64_t)row * LANES;
        lo = p[c + a];
        hi = p[n_attrs + c + a];
      }
      s.rlo[a][row] = lo;
      s.rhi[a][row] = hi;
    }
    __syncthreads();
    for (int a = 0; a < k && alive; ++a) {
      const int rlo = s.rlo[a][tx], rhi = s.rhi[a][tx];
      uint32_t m = alive;
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1u;
        if (!(s.qlo[a][b] <= rhi && rlo <= s.qhi[a][b])) alive &= ~(1u << b);
      }
    }
    // one barrier both ends the block's reads of this chunk and tells every
    // thread whether any verdict is still 1 (the block-uniform early exit)
    if (!__syncthreads_or(alive != 0u)) break;
  }
  if (tx < nr) {
    for (int b = 0; b < nq; ++b) out[(int64_t)b * out_stride + tx] = (uint8_t)((alive >> b) & 1u);
  }
}

__global__ void __launch_bounds__(TR)
range_join_tile_masks_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ r,
                             const int32_t* __restrict__ tile_q,
                             const int32_t* __restrict__ tile_r,
                             uint8_t* __restrict__ out, int bq, int br, int n_attrs) {
  __shared__ Stage s;
  const int64_t t = blockIdx.x;
  const int n_rt = (br + TR - 1) / TR;
  const int sub_q = blockIdx.y / n_rt, sub_r = blockIdx.y - (blockIdx.y / n_rt) * n_rt;
  const int64_t q0 = (int64_t)tile_q[t] * bq + (int64_t)sub_q * TQ;
  const int64_t r0 = (int64_t)tile_r[t] * br + (int64_t)sub_r * TR;
  const int nqv = min(TQ, bq - sub_q * TQ);
  const int nrv = min(TR, br - sub_r * TR);
  uint8_t* o = out + t * (int64_t)bq * br + (int64_t)sub_q * TQ * br + (int64_t)sub_r * TR;
  eval_tile(q + q0 * LANES, nqv, r + r0 * LANES, nrv, n_attrs, o, br, s);
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
  const long long n_qt = (nq + MQ - 1) / MQ;
  const long long n_rt = (nr + MR - 1) / MR;
  if (n_rt > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // q tiles a block: one, unless the grid would run more than about four
  // waves of two blocks an SM; then as many as keep it to that
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long per = n_qt * n_rt / (8LL * sms);
  if (per < 1) per = 1;
  const long long n_y = (n_qt + per - 1) / per;
  // the widest store every thread's 16 bytes allow: a row starts at q * nr
  // and a thread's bytes at a multiple of 16 past it
  const unsigned long long bits = (unsigned long long)nr | (uintptr_t)out | 16u;
  const int align = (int)(bits & (~bits + 1u));
  dim3 grid((unsigned)n_rt, (unsigned)(n_y < 65535 ? n_y : 65535));
  range_join_mask_kernel<<<grid, MT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)q, (const int32_t*)r, (uint8_t*)out, nq, nr, n_attrs, n_qt, per, align);
  return (int)cudaGetLastError();
}

int rj_range_join_tile_masks(const void* q, const void* r, const void* tile_q,
                             const void* tile_r, void* out, long long n_tiles,
                             int bq, int br, int n_attrs, void* stream) {
  if (n_tiles <= 0 || bq <= 0 || br <= 0) return 0;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int subtiles = ((bq + TQ - 1) / TQ) * ((br + TR - 1) / TR);
  if (subtiles > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)n_tiles, (unsigned)subtiles);
  range_join_tile_masks_kernel<<<grid, TR, 0, (cudaStream_t)stream>>>(
      (const int32_t*)q, (const int32_t*)r, (const int32_t*)tile_q,
      (const int32_t*)tile_r, (uint8_t*)out, bq, br, n_attrs);
  return (int)cudaGetLastError();
}

const char* rj_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
