// Fused multi-segment hash probe + backward-pointer chain walk for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/hash_probe.py::fused_lookup_tiles
// (body _fused_lookup_kernel).  Contract, per int64 query key:
//   1. hash the key (splitmix64, then the high bits of a golden-ratio
//      product, bit-identical to core/hashing.py::bucket_hash);
//   2. probe each segment's bucket row newest -> oldest, each modulo its own
//      power-of-two bucket count; a row resolves to max(ptr where key
//      matches, else NULL) and the first non-NULL row is the head;
//   3. drop the head unless it is below `fill` (read from device memory);
//   4. walk the flat `prev` array for max_matches hops, emitting row ids
//      newest first and masking every hop by `fill`;
//   5. store the would-be next pointer in `last` (>= 0 means truncated).
// The plain PyTorch version is kernels/ref.py::fused_lookup_ref.
//
// What bounds it on the card: bytes.  Each query reads, in each of S
// segments, one random 64-byte key row and one 32-byte pointer row, then
// makes max_matches dependent 4-byte `prev` loads, each of which costs a
// 32-byte sector.  There is no arithmetic to speak of.
//
// Design: one thread per query; keys are compared as native int64 and
// hashed here, so the host passes neither bucket ids nor split key planes
// and the query count needs no padding (the ragged edge is masked).  One
// launch covers any number of segments: `segs` is a small device array of
// (keys plane, ptrs plane, bucket count) triples, built once per snapshot
// version by the Python wrapper.  Latency of the dependent loads is hidden
// by occupancy only; faster layouts are later work.
#include <cuda_runtime.h>

namespace {

struct SegDesc {
  const long long* keys;   // [num_buckets, slots] int64, EMPTY = INT64_MIN
  const int* ptrs;         // [num_buckets, slots] int32, NULL = -1
  long long num_buckets;   // a power of two
};

constexpr unsigned long long kMix1 = 0xBF58476D1CE4E5B9ull;
constexpr unsigned long long kMix2 = 0x94D049BB133111EBull;
constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ull;
constexpr int kNull = -1;

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  x = (x ^ (x >> 30)) * kMix1;
  x = (x ^ (x >> 27)) * kMix2;
  return x ^ (x >> 31);
}

__global__ void fused_lookup_kernel(const long long* __restrict__ query,
                                    long long num_queries,
                                    const SegDesc* __restrict__ segs,
                                    int num_segments, int slots,
                                    const int* __restrict__ prev,
                                    long long capacity,
                                    const int* __restrict__ fill_ptr,
                                    int max_matches,
                                    int* __restrict__ rows,
                                    int* __restrict__ last) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_queries) return;
  const long long key = query[i];
  const unsigned long long h =
      splitmix64(static_cast<unsigned long long>(key)) * kGolden;
  const int fill = *fill_ptr;

  int head = kNull;
  for (int s = num_segments - 1; s >= 0; --s) {
    const SegDesc d = segs[s];
    const int lg = 63 - __clzll(d.num_buckets);
    // a shift by 64 (one bucket) gives 0, as XLA's shift does
    const long long b =
        lg == 0 ? 0 : static_cast<long long>(h >> (64 - lg)) & (d.num_buckets - 1);
    const long long* krow = d.keys + b * slots;
    const int* prow = d.ptrs + b * slots;
    int cand = kNull;
    for (int j = 0; j < slots; ++j) {
      if (krow[j] == key) cand = max(cand, prow[j]);
    }
    if (cand != kNull) {
      head = cand;
      break;
    }
  }
  int cur = head < fill ? head : kNull;

  int* out = rows + i * max_matches;
  for (int m = 0; m < max_matches; ++m) {
    out[m] = cur;
    int nxt = kNull;
    if (cur >= 0) nxt = prev[min(static_cast<long long>(cur), capacity - 1)];
    cur = nxt < fill ? nxt : kNull;
  }
  last[i] = cur;
}

}  // namespace

extern "C" {

// Launches on `stream` of `device` and returns the CUDA error code
// (0 = launched).  The calling thread's current device is restored before
// returning.
int fused_lookup_launch(int device, const long long* query,
                        long long num_queries, const void* segs,
                        int num_segments, int slots, const int* prev,
                        long long capacity, const int* fill, int max_matches,
                        int* rows, int* last, void* stream) {
  if (num_queries <= 0) return 0;
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (caller_device != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 256;
  const long long blocks = (num_queries + threads - 1) / threads;
  fused_lookup_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      query, num_queries, static_cast<const SegDesc*>(segs), num_segments,
      slots, prev, capacity, fill, max_matches, rows, last);
  err = cudaGetLastError();
  if (caller_device != device) {
    const cudaError_t restore = cudaSetDevice(caller_device);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

const char* fused_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
