// Exact greedy NMS over score-sorted candidates, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel face_crop_plus_tpu/ops/pallas/nms_kernel.py:
// _nms_kernel (launched by greedy_nms_mask_pallas).  Same function: boxes
// (N, K, 4) f32 corner form, score-descending; valid (N, K) bool → keep
// (N, K) bool, where i suppresses every j > i with IoU(i, j) > thr when i is
// itself still kept and valid.  IoU uses the reference's +1-pixel area
// convention and inter / max(union, 1e-12).
//
// What bounds it on this card: not bytes (N·K·17 B in, N·K B out) and not
// operations (about 20 f32 operations per pair, N·K²/2 pairs, against the
// card's f32 rate), but the K-step dependent scan, a chain of K short
// steps.  The TPU kernel keeps a (K, K) f32 IoU tile in VMEM (4 MB at
// K = 1024), which does not fit the 227 KB a Hopper block may use.  So:
//
//   Pass 1 (nms_mask_kernel): one thread per row i, one block per 64-column
//   tile and 64-row tile of one image, writes a 64-bit word with bit j set
//   when j > i and IoU(i, j) > thr.  Tiles left of the diagonal hold no bits
//   and are skipped (never written, never read).  The mask is
//   N·K·ceil(K/64)·8 bytes (2 MB at N = 16, K = 1024), allocated by the
//   caller.  This pass is fully parallel: N·ceil(K/64)² blocks.
//
//   Pass 2 (nms_scan_kernel): one block per image copies that image's mask
//   words and validity into shared memory (at most 128 KB + 1 KB at
//   K = 1024), then one warp walks i = 0..K-1.  Lane l owns the "removed"
//   bits of candidates 64l..64l+63; __shfl_sync from the owner says whether
//   i is alive, and when it is alive and valid every lane ORs its word of
//   row i into "removed".  Each step of the chain is one shuffle, one
//   shared-memory load and one OR, with no global-memory latency in it.
//
// Exactness: build without fast math (IEEE division) and with -fmad=false,
// so no product and sum contract into an FMA that rounds differently from
// the plain PyTorch version; the order of operations is the JAX one
// (union = (area_i + area_j) - inter, then max(union, 1e-12), then the
// quotient compared with thr).  fmaxf/fminf drop NaN while jnp.maximum and
// torch.maximum propagate it, so max_nan/min_nan below propagate NaN.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ boxes,
                unsigned long long* __restrict__ mask, int k, int words,
                float thr) {
  const int t = blockIdx.x;   // column tile
  const int rt = blockIdx.y;  // row tile
  if (t < rt) return;         // every j < every i: no bits, never read
  const int tid = threadIdx.x;
  const float* b = boxes + (size_t)blockIdx.z * k * 4;

  __shared__ float cb[5][kTile];  // x1, y1, x2, y2, area of the column tile
  const int j0 = t * kTile;
  if (j0 + tid < k) {
    const float* p = b + (size_t)(j0 + tid) * 4;
    const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
    cb[0][tid] = x1;
    cb[1][tid] = y1;
    cb[2][tid] = x2;
    cb[3][tid] = y2;
    cb[4][tid] = (x2 - x1 + 1.0f) * (y2 - y1 + 1.0f);
  }
  __syncthreads();

  const int i = rt * kTile + tid;
  if (i >= k) return;
  const float* p = b + (size_t)i * 4;
  const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
  const float area = (x2 - x1 + 1.0f) * (y2 - y1 + 1.0f);
  const int jn = min(kTile, k - j0);

  unsigned long long bits = 0;
  for (int jj = 0; jj < jn; ++jj) {
    if (j0 + jj <= i) continue;
    const float ix1 = max_nan(x1, cb[0][jj]);
    const float iy1 = max_nan(y1, cb[1][jj]);
    const float ix2 = min_nan(x2, cb[2][jj]);
    const float iy2 = min_nan(y2, cb[3][jj]);
    const float iw = max_nan(0.0f, ix2 - ix1 + 1.0f);
    const float ih = max_nan(0.0f, iy2 - iy1 + 1.0f);
    const float inter = iw * ih;
    const float uni = max_nan(area + cb[4][jj] - inter, 1e-12f);
    if (inter / uni > thr) bits |= 1ull << jj;
  }
  mask[((size_t)blockIdx.z * k + i) * words + t] = bits;
}

__global__ void __launch_bounds__(256)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int k, int words) {
  extern __shared__ unsigned long long sm[];  // k*words mask words, k bytes
  unsigned char* vs = reinterpret_cast<unsigned char*>(sm + (size_t)k * words);
  const size_t n = blockIdx.x;
  const unsigned long long* m = mask + n * k * words;
  const unsigned char* v = valid + n * k;
  // Lower-triangle words were never written; they are copied, never read.
  for (int e = threadIdx.x; e < k * words; e += blockDim.x) sm[e] = m[e];
  for (int e = threadIdx.x; e < k; e += blockDim.x) vs[e] = v[e];
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  unsigned long long removed = 0;  // candidates 64*lane .. 64*lane + 63
  for (int i = 0; i < k; ++i) {
    const int w = i >> 6;
    const unsigned long long r = __shfl_sync(0xffffffffu, removed, w);
    const bool alive = vs[i] && !((r >> (i & 63)) & 1ull);
    if (alive && lane >= w && lane < words) {
      removed |= sm[(size_t)i * words + lane];
    }
  }

  unsigned char* out = keep + n * k;
  for (int bit = 0; bit < kTile; ++bit) {
    const int j = lane * kTile + bit;
    if (j < k) out[j] = vs[j] && !((removed >> bit) & 1ull);
  }
}

}  // namespace

// Launches both passes on `stream` without synchronising.  `mask` is
// caller-allocated scratch of n*k*ceil(k/64) words.  Requires 1 <= k <= 1024
// and n >= 1.  Returns cudaGetLastError() after the launches (0 = success).
extern "C" int fcpt_greedy_nms_mask(const float* boxes,
                                    const unsigned char* valid,
                                    unsigned long long* mask,
                                    unsigned char* keep, int n, int k,
                                    float thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + kTile - 1) / kTile;
  nms_mask_kernel<<<dim3(words, words, n), kTile, 0, s>>>(boxes, mask, k,
                                                          words, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)k * words * 8 + k;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<n, 256, smem, s>>>(mask, valid, keep, k, words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fcpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
