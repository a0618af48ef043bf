// Run-boundary flags of a sorted packed table for Hopper (sm_90a), bound
// with ctypes.
//
// Replaces the Pallas TPU kernel run_boundaries_packed of
// src/repro/kernels/run_boundary.py:86 (body _kernel, tail side input and
// sentinel row built in the wrapper).
//
// For a packed [N, 128] int32 table sorted by its group key (lanes
// [0, n_keys) hold the keys, lane n_keys the merge column's lo, lane
// n_keys + 1 its hi) it writes, as uint8 0/1,
//
//     flag[0] = 1
//     flag[t] = OR_j (key_j[t] != key_j[t-1])  ||  lo[t] > hi[t-1] + 1
//
// where hi + 1 wraps in int32 (INT32_MAX + 1 == INT32_MIN), as the plain
// version's int32 arithmetic does.  The wrap is written as an unsigned add
// and a cast back, so the C++ has no signed overflow.
//
// What bounds it on an H100: the live sectors it reads plus the N flag
// bytes it writes, over HBM bandwidth.  Only lanes [0, n_keys + 2) of each
// 512-byte row are live: one 32-byte sector a row up to 6 keys, the whole
// row at 126.  It does at most n_keys + 1 compares a row.
//
// What the design does about it:
//   * coalesced reads of the live lanes only: a block copies rows
//     [first - 1, first + pass) into shared memory as 16-byte chunks,
//     neighbouring threads on neighbouring chunks, with cp.async, so every
//     load of the pass is in flight at once and no register holds it; at
//     n_keys + 2 <= 8 a warp reads several rows per instruction, at 126 keys
//     one whole row per 32 chunks;
//   * each row is read from device memory once: row t-1 of the pass's first
//     row is the staged halo row, and the compares read both rows from
//     shared memory, each thread one 16-byte chunk of row t against the
//     same chunk of row t-1 (conflict-free), setting the row's flag in
//     shared memory where its chunk shows a change;
//   * the flags go out four to a thread as one 32-bit store where aligned;
//   * row 0 is set to 1 directly where the TPU compared it with a sentinel
//     row of INT32_MIN (which a row of INT32_MIN keys and lo <= INT32_MIN + 1
//     equals; the plain version flags row 0 all the same);
//   * a block takes block_rows consecutive rows (the TPU's tile) in passes
//     of at most pass_rows rows, sized so a pass stays near 40 KB of shared
//     memory; block_rows changes only the grid, never a flag.  Blocks are
//     independent: there is no side input of tile tails.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int PASS_BYTES = 40 * 1024;  // staged rows a pass, at most
constexpr int MAX_PASS_ROWS = 1024;

__global__ void __launch_bounds__(THREADS)
run_boundaries_kernel(const int32_t* __restrict__ packed, uint8_t* __restrict__ out,
                      long long n, long long block_rows, int n_keys, int pass_rows) {
  extern __shared__ int4 smem4[];
  const int nvec = (n_keys + 2 + 3) >> 2;  // 16-byte chunks a row
  // row = e / nvec as a multiply-high: exact for e * nvec < 2^32
  const uint32_t magic = nvec == 1 ? 0u : 0xffffffffu / (uint32_t)nvec + 1u;
  int4* s_rows = smem4;  // [pass_rows + 1][nvec], the halo row first
  const int32_t* s_lanes = reinterpret_cast<const int32_t*>(smem4);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(smem4 + (pass_rows + 1) * nvec);
  const int lo_vec = n_keys >> 2;  // the chunk that holds lane n_keys (lo)
  const long long first = (long long)blockIdx.x * block_rows;
  const long long last = first + block_rows < n ? first + block_rows : n;
  for (long long s = first; s < last; s += pass_rows) {
    const int rows = (int)(last - s < pass_rows ? last - s : pass_rows);
    const int total = (rows + 1) * nvec;
    if (s != first) __syncthreads();  // the last pass is done with shared memory
    for (int e = threadIdx.x; e < total; e += THREADS) {
      const int row = nvec == 1 ? e : (int)__umulhi((uint32_t)e, magic);
      const long long g = s - 1 + row;  // row 0 of the table has no halo
      if (g >= 0)
        __pipeline_memcpy_async(&s_rows[e],
                                reinterpret_cast<const int4*>(packed + g * LANES) + (e - row * nvec),
                                sizeof(int4));
    }
    __pipeline_commit();
    for (int i = threadIdx.x; i < rows; i += THREADS) s_flag[i] = s + i == 0 ? 1 : 0;
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int e = nvec + threadIdx.x; e < total; e += THREADS) {
      const int row = nvec == 1 ? e : (int)__umulhi((uint32_t)e, magic);
      const int vi = e - row * nvec;
      if (s - 1 + row == 0) continue;  // table row 0: set above
      const int4 cur = s_rows[e];
      const int4 prev = s_rows[e - nvec];
      const int l = 4 * vi;  // first lane of this chunk
      bool changed = (l < n_keys && cur.x != prev.x) | (l + 1 < n_keys && cur.y != prev.y) |
                     (l + 2 < n_keys && cur.z != prev.z) | (l + 3 < n_keys && cur.w != prev.w);
      if (vi == lo_vec) {
        const int32_t lo = s_lanes[row * nvec * 4 + n_keys];
        const int32_t hi_prev = s_lanes[(row - 1) * nvec * 4 + n_keys + 1];
        changed |= lo > (int32_t)((uint32_t)hi_prev + 1u);
      }
      if (changed) s_flag[row - 1] = 1;
    }
    __syncthreads();
    uint8_t* o = out + s;
    for (int i = 4 * threadIdx.x; i < rows; i += 4 * THREADS) {
      if (i + 4 <= rows && ((uintptr_t)(o + i) & 3u) == 0) {
        *reinterpret_cast<uint32_t*>(o + i) = *reinterpret_cast<const uint32_t*>(s_flag + i);
      } else {
        for (int b = i; b < rows && b < i + 4; ++b) o[b] = s_flag[b];
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (0 when n is 0 and
// nothing was launched), or the error that refused the arguments.
int rb_run_boundaries(const void* packed, void* out, long long n, int n_keys,
                      int block_rows, void* stream) {
  if (n <= 0) return 0;
  if (block_rows <= 0 || n_keys < 0 || n_keys + 2 > LANES)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)packed & 15u) return (int)cudaErrorMisalignedAddress;  // 16-byte chunks
  const long long blocks = (n + block_rows - 1) / block_rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int nvec = (n_keys + 2 + 3) / 4;
  int pass_rows = PASS_BYTES / (16 * nvec);
  if (pass_rows > MAX_PASS_ROWS) pass_rows = MAX_PASS_ROWS;
  if (pass_rows > block_rows) pass_rows = block_rows;
  const size_t smem = (size_t)(pass_rows + 1) * nvec * 16 + pass_rows;
  run_boundaries_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)packed, (uint8_t*)out, n, block_rows, n_keys, pass_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
