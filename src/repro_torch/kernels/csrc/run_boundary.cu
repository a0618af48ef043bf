// Run-boundary flags of a sorted packed table for Hopper (sm_90a), bound
// with ctypes.
//
// Replaces the Pallas TPU kernel run_boundaries_packed of
// src/repro/kernels/run_boundary.py (body _kernel, tail side input and
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
// What it reads: lanes [0, n_keys + 2) of rows t and t-1.  The rows are
// 512 bytes apart and only those lanes are active, so a row costs one
// 32-byte sector for n_keys <= 6 (two past that, up to the whole row at
// n_keys = 126); the other 120-odd lanes are never touched.  Row t-1 is the
// row that thread t-1 reads, so the second read of a sector hits L1/L2.
//
// What bounds it on an H100: those bytes (one sector a row at the widths
// ProvRC uses) plus the N flag bytes written, over HBM bandwidth; it does
// at most n_keys + 1 compares a row.
//
// What the design does about it:
//   * one thread per row, the key loop ending at the first changed key;
//   * no padding: a bounds check on N replaces the TPU's copies of the last
//     row, and row 0 is set to 1 directly where the TPU compared it with a
//     sentinel row of INT32_MIN (which a row of INT32_MIN keys and
//     lo <= INT32_MIN + 1 equals; the plain version flags row 0 all the
//     same);
//   * no side input of tile tails: a block reads row t-1 of its first row
//     from device memory like any other row, so blocks are independent;
//   * a block takes block_rows consecutive rows (the TPU's tile), looping
//     its 256 threads over them; block_rows changes only the grid, never a
//     flag.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
run_boundaries_kernel(const int32_t* __restrict__ packed, uint8_t* __restrict__ out,
                      long long n, long long block_rows, int n_keys) {
  const long long first = (long long)blockIdx.x * block_rows;
  const long long last = first + block_rows < n ? first + block_rows : n;
  for (long long t = first + threadIdx.x; t < last; t += THREADS) {
    if (t == 0) {
      out[0] = 1;
      continue;
    }
    const int32_t* row = packed + t * LANES;
    const int32_t* prev = row - LANES;
    uint8_t flag = 0;
    for (int j = 0; j < n_keys; ++j) {
      if (row[j] != prev[j]) {
        flag = 1;
        break;
      }
    }
    if (!flag) {
      const int32_t next_lo = (int32_t)((uint32_t)prev[n_keys + 1] + 1u);
      flag = row[n_keys] > next_lo;
    }
    out[t] = flag;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() right after the launch (0 when n is 0 and
// nothing was launched).
int rb_run_boundaries(const void* packed, void* out, long long n, int n_keys,
                      int block_rows, void* stream) {
  if (n <= 0) return 0;
  if (block_rows <= 0 || n_keys < 0 || n_keys + 2 > LANES)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + block_rows - 1) / block_rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  run_boundaries_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)packed, (uint8_t*)out, n, block_rows, n_keys);
  return (int)cudaGetLastError();
}

}  // extern "C"
