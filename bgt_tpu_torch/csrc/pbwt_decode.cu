// The PBWT decode scan on Hopper (sm_90a): kernel D.
//
// Replaces bgt_tpu/ops/decode.py:63 decode_block, which is not a Pallas
// kernel but an XLA lax.scan over the rows of one PBWT checkpoint block.
// For each row, from the permutation S before it and the row's byte-runs
// (length, bit), it computes
//
//     starts = exclusive_cumsum(run lengths)
//     y[i]   = bit of rank i (transitions scattered at the run starts, then
//              a running sum)
//     a[S[i]] = y[i]                     the row in original column order
//     S'     = stable partition of S by y (zeros first)
//
// and writes a as one (m,) uint8 row of the output; S' is the next row's S.
//
// What bounds it on this card: not device memory.  The bytes it must move
// (the runs read once, S0 and the final S, one output byte per haplotype per
// row) take ~4 ms for the 13 GB of a 100,000-row x 64,976-haplotype cohort
// at 3.35 TB/s, but within a block the recurrence is sequential: row k+1
// needs all of row k's S'.  So one block owns one scan and loops over its
// rows, and the scans of a batch (checkpoint blocks x planes) are its only
// parallelism: 26 blocks for that cohort against 132 SMs.  Each row then
// costs what one SM takes to move ~9 bytes per haplotype through L2 (S read,
// S' written, one scattered output byte: its own L2 sector write) plus a
// few block-wide barriers; PERF.md has the measured time per row.
//
// What the design does about it:
// - every scan of a batch goes in one launch, one block of 1,024 threads
//   per scan (gridDim.x = scans), each with its own row count;
// - S does not fit in shared memory at HRC width (64,976 ints is 260 KB), so
//   it is double-buffered in global scratch that the wrapper allocates,
//   (scans, 2, m) int32, 13.5 MB for 26 scans, which stays in the 50 MB L2;
//   the first row reads S0 and the last row writes the final S directly;
// - y lives in shared memory as a bitmap (m bits; 8 KB at HRC width).  The
//   runs are turned into transition bits (a run whose bit differs from the
//   previous run's, with a nonzero length and a start below m, flips its
//   start bit with atomicXor), and y is their prefix XOR: inside a word by
//   shifts, across words by a block scan of the words' parities.  A second
//   block scan of the words' popcounts gives the exclusive count of ones
//   before each word, so a haplotype's destination in S' is one popcount
//   away.  Long runs cost one byte-run each and never loop over their bits;
//   zero-length padding runs and starts at or past m touch nothing;
// - runs come either from the RLE bytes themselves, decoded in the kernel
//   as ((t & 15) << 4 * (t >> 4), v & 1) with t = v >> 1 (concatenated rows
//   with int64 offsets: one byte per run, no padding), or from the padded
//   int32 (rows, max_runs) lens/bits arrays of bgt_tpu's decode_block;
// - the output write a[S[i]] = y[i] is a byte scatter and stays uncoalesced;
//   the S' writes are compacting (zeros and ones each land in order).
//   Nothing is written outside the output row or S': an S entry outside
//   [0, m) writes no output byte, and the destinations are in [0, m) by
//   construction.
//
// Interface: a plain C entry point (bgt_pbwt_decode) bound with ctypes.  It
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns the first CUDA error it meets (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Block-wide exclusive prefix sum of one value per thread; the block total
// goes to *total.  Every thread of the block must call it.  `scratch` holds
// kWarps values and is free again when the function returns.
__device__ __forceinline__ long long block_exclusive_sum(long long v, long long* scratch,
                                                         long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long up = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += up;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = scratch[lane];  // kWarps == 32: one warp total per lane
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long up = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += up;
    }
    scratch[lane] = s;
  }
  __syncthreads();
  const long long before = (warp ? scratch[warp - 1] : 0) + x - v;
  *total = scratch[kWarps - 1];
  __syncthreads();
  return before;
}

// Run j of the row sources: an RLE byte, or one entry of the padded arrays.
template <bool kBytes>
__device__ __forceinline__ void run_at(const uint8_t* rle, const int32_t* lens,
                                       const int32_t* bits, long long j,
                                       long long* len, int* bit) {
  if (kBytes) {
    const unsigned v = rle[j];
    const unsigned t = v >> 1;
    *len = (long long)(t & 15u) << (4 * (t >> 4));
    *bit = (int)(v & 1u);
  } else {
    *len = lens[j];
    *bit = bits[j];
  }
}

// One block per scan.  Scan k decodes rows [scan_row0[k], scan_row0[k+1])
// of the output from S0[k]; row r's runs are [run_off[r], run_off[r+1]) of
// the run source.  S_buf: (scans, 2, m) scratch; S_final: (scans, m).
// Dynamic shared memory: 2 * ceil(m / 32) words.
template <bool kBytes>
__global__ void __launch_bounds__(kThreads, 1)
pbwt_decode_kernel(const int32_t* S0, const uint8_t* __restrict__ rle,
                   const int32_t* __restrict__ lens, const int32_t* __restrict__ bits,
                   const long long* __restrict__ run_off,
                   const long long* __restrict__ scan_row0, uint8_t* out,
                   int32_t* S_buf, int32_t* S_final, int m) {
  extern __shared__ uint32_t smem[];
  __shared__ long long scratch[kWarps];
  const int W = (m + 31) >> 5;
  uint32_t* yw = smem;                                         // transitions, then y
  int* ones_before = reinterpret_cast<int*>(smem + W);         // ones in earlier words
  const int tid = threadIdx.x;
  const size_t ms = (size_t)m;
  const int k = blockIdx.x;
  const long long r0 = scan_row0[k];
  const long long r1 = scan_row0[k + 1];
  // S is read and written by every thread of the block within one launch,
  // so it goes through plain (coherent) loads and stores, not __ldg
  const int32_t* cur = S0 + (size_t)k * ms;
  int32_t* const bufs[2] = {S_buf + (size_t)(2 * k) * ms, S_buf + (size_t)(2 * k + 1) * ms};
  int32_t* const fin = S_final + (size_t)k * ms;
  if (r0 >= r1) {
    for (int i = tid; i < m; i += kThreads) fin[i] = cur[i];
    return;
  }
  // each thread's contiguous segment of bitmap words for the two scans
  const int per = (W + kThreads - 1) / kThreads;
  const int w0 = min(tid * per, W);
  const int w1 = min(w0 + per, W);
  const uint32_t tail = (m & 31) ? (1u << (m & 31)) - 1u : kFull;
  long long total;

  for (long long r = r0; r < r1; ++r) {
    int32_t* const nxt = r + 1 == r1 ? fin : bufs[(r - r0) & 1];
    for (int w = tid; w < W; w += kThreads) yw[w] = 0u;
    __syncthreads();

    // 1. transition bits at the run starts
    const long long a = run_off[r];
    const long long n_runs = run_off[r + 1] - a;
    long long carry = 0;
    for (long long base = 0; base < n_runs; base += kThreads) {
      const long long j = base + tid;
      long long len = 0, prev_len;
      int bit = 0, prev = 0;
      if (j < n_runs) {
        run_at<kBytes>(rle, lens, bits, a + j, &len, &bit);
        if (j > 0) run_at<kBytes>(rle, lens, bits, a + j - 1, &prev_len, &prev);
      }
      const long long start = carry + block_exclusive_sum(len, scratch, &total);
      if (len > 0 && bit != prev && start >= 0 && start < m)
        atomicXor(&yw[start >> 5], 1u << (start & 31));
      carry += total;
    }
    __syncthreads();

    // 2. y = prefix XOR of the transitions; ones before each word
    unsigned par = 0;
    for (int w = w0; w < w1; ++w) par ^= __popc(yw[w]) & 1u;
    uint32_t flip = block_exclusive_sum(par, scratch, &total) & 1 ? kFull : 0u;
    int ones = 0;
    for (int w = w0; w < w1; ++w) {
      const uint32_t t = yw[w];
      uint32_t x = t;
      x ^= x << 1;
      x ^= x << 2;
      x ^= x << 4;
      x ^= x << 8;
      x ^= x << 16;
      x ^= flip;
      if (__popc(t) & 1) flip = ~flip;
      if (w == W - 1) x &= tail;
      yw[w] = x;
      ones += __popc(x);
    }
    int before = (int)block_exclusive_sum(ones, scratch, &total);
    const int n0 = m - (int)total;
    for (int w = w0; w < w1; ++w) {
      ones_before[w] = before;
      before += __popc(yw[w]);
    }
    __syncthreads();

    // 3. the row in original order, and the stable partition of S
    uint8_t* const row = out + (size_t)r * ms;
    for (int i = tid; i < m; i += kThreads) {
      const int32_t s = cur[i];
      const uint32_t word = yw[i >> 5];
      const int b = i & 31;
      const unsigned y = (word >> b) & 1u;
      const int o = ones_before[i >> 5] + __popc(word & ((1u << b) - 1u));
      if ((unsigned)s < (unsigned)m) row[s] = (uint8_t)y;
      nxt[y ? n0 + o : i - o] = s;
    }
    __syncthreads();  // S' complete and visible before the next row reads it
    cur = nxt;
  }
}

}  // namespace

// S0: (scans, m) int32.  Runs: rle (uint8 RLE bytes) when it is not null,
// else lens/bits (int32); row r's runs are entries [run_off[r], run_off[r+1])
// of that source.  scan_row0: (scans + 1) int64, scan k owns output rows
// [scan_row0[k], scan_row0[k+1]).  out: (scan_row0[scans], m) uint8.
// S_buf: (scans, 2, m) int32 scratch.  S_final: (scans, m) int32, the S after
// each scan's last row (S0 for a scan of no rows).  stream: a cudaStream_t.
// Launches nothing when scans or m is 0.
extern "C" int bgt_pbwt_decode(const void* S0, const void* rle, const void* lens,
                               const void* bits, const void* run_off,
                               const void* scan_row0, void* out, void* S_buf,
                               void* S_final, int scans, int m, void* stream) {
  if (scans <= 0 || m <= 0) return 0;
  const size_t smem = 2 * sizeof(uint32_t) * (size_t)((m + 31) / 32);
  auto kernel = rle ? pbwt_decode_kernel<true> : pbwt_decode_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<scans, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(S0), static_cast<const uint8_t*>(rle),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(bits),
      static_cast<const long long*>(run_off), static_cast<const long long*>(scan_row0),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(S_buf),
      static_cast<int32_t*>(S_final), m);
  return (int)cudaGetLastError();
}
