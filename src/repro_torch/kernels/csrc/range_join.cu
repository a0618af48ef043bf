// Interval-overlap range joins for Hopper (sm_90a), bound with ctypes.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/range_join.py:
//   * range_join_mask        (range_join.py:96, body _kernel, padding _pad_empty)
//   * range_join_tile_masks  (range_join.py:154, body _tile_kernel,
//                             PrefetchScalarGridSpec schedule)
//
// Both compute, for packed [N, 128] int32 boxes (lanes [0, n_attrs) hold the
// lo bounds, lanes [n_attrs, 2*n_attrs) the hi bounds):
//
//     mask[q, r] = AND_j (q.lo_j <= r.hi_j  &&  r.lo_j <= q.hi_j)
//
// and write it as uint8 0/1.
//
// What bounds them on an H100: the mask bytes written.  Each output byte
// costs at most 2*n_attrs int32 compares, and the operands are small next to
// the mask (NQ + NR rows of 2*n_attrs lanes against NQ*NR output bytes), so
// the work is write-bound at low widths.  With 2 attributes a byte costs 4
// compares; the card's int32 rate is far above 4 compares per byte of
// memory bandwidth.  The TPU kernel wrote an int32 mask; this one writes
// uint8, a quarter of the bytes.
//
// What the design does about it:
//   * one thread owns one r row and 32 q rows, and keeps the 32 verdicts as
//     bits of one register, so the compares never leave registers and the
//     attribute loop ends as soon as every verdict of the block is 0;
//   * the block stages its q and r rows' active lanes (only lanes < 2*n_attrs
//     are read) in shared memory, 8 attributes at a time, so the staging
//     buffer is 10 KB whatever the width;
//   * the stores are r-contiguous: the 32 threads of a warp write 32
//     neighbouring bytes of one mask row;
//   * bounds checks take the place of the TPU's empty-box padding, and all
//     output offsets are 64-bit (NQ * NR passes 2^31 on real frontiers).
//
// The tile kernel reads its schedule (tile_q[t], tile_r[t]) from device
// int32 arrays where the TPU prefetched it into scalar memory; the tile
// index t runs on gridDim.x because gridDim.y and z stop at 65,535.
// No wgmma or TMA: an integer compare has no use for the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int TQ = 32;     // q rows per block: one bit each of a 32-bit mask
constexpr int TR = 128;    // r rows per block: one per thread
constexpr int CHUNK = 8;   // attributes staged in shared memory per pass

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

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
range_join_mask_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ r,
                       uint8_t* __restrict__ out, int64_t nq, int64_t nr,
                       int n_attrs, int64_t n_qt) {
  __shared__ Stage s;
  const int64_t r0 = (int64_t)blockIdx.x * TR;
  const int nrv = (int)min64(TR, nr - r0);
  // q tiles stride over gridDim.y, which stops at 65,535
  for (int64_t qt = blockIdx.y; qt < n_qt; qt += gridDim.y) {
    const int64_t q0 = qt * TQ;
    const int nqv = (int)min64(TQ, nq - q0);
    eval_tile(q + q0 * LANES, nqv, r + r0 * LANES, nrv, n_attrs,
              out + q0 * nr + r0, nr, s);
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
// nothing was launched because a dimension is 0).

int rj_range_join_mask(const void* q, const void* r, void* out, long long nq,
                       long long nr, int n_attrs, void* stream) {
  if (nq <= 0 || nr <= 0) return 0;
  const long long n_qt = (nq + TQ - 1) / TQ;
  const long long n_rt = (nr + TR - 1) / TR;
  if (n_rt > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)n_rt, (unsigned)(n_qt < 65535 ? n_qt : 65535));
  range_join_mask_kernel<<<grid, TR, 0, (cudaStream_t)stream>>>(
      (const int32_t*)q, (const int32_t*)r, (uint8_t*)out, nq, nr, n_attrs, n_qt);
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
