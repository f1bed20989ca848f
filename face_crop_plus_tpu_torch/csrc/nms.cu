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
// operations (about 20 f32 operations per pair of the upper triangle), but
// issue and latency.  The first version (one thread per row running a
// 64-step loop of NaN-checked min/max, one warp scanning one candidate per
// step with a shuffle and two shared loads each) took 0.109 ms at N = 16,
// K = 1024 on an H100 80GB HBM3 (700 W): mask pass 44.6 us, scan 64.7 us.
// The TPU kernel keeps a (K, K) f32 IoU tile in VMEM (4 MB at K = 1024),
// which does not fit the 227 KB a Hopper block may use, so this kernel keeps
// one bit per pair.  Its two passes:
//
//   Pass 1 (nms_mask_kernel): one block of 256 threads per upper-triangle
//   64x64 tile (the grid enumerates only those, W(W+1)/2 of W² with W =
//   ceil(K/64)), one thread per two pairs of a row: lane l of warp v tests
//   columns 64·ct + l and 64·ct + 32 + l against rows v, v + 8, ..., and
//   two __ballot_sync pack each row's 64 results into its word.  The pair test needs no
//   NaN-checked min/max: a NaN coordinate in either box makes the reference
//   IoU NaN, so the pair is false (a per-box flag); without NaN coordinates
//   fmaxf/fminf equal the NaN-propagating maximum/minimum, and the two NaNs
//   that inf coordinates or overflow can still make (inf - inf in a width,
//   inf·0 in an area) propagate through compare-selects, as in the reference.
//   The mask is N·Kp·W·8 bytes with Kp = 64·W rows (2 MB at N = 16,
//   K = 1024), allocated by the caller; rows past K and tiles below the
//   diagonal are never written and never read.
//
//   Pass 2 (nms_scan_kernel): one warp per image.  Lane 0 starts one TMA
//   bulk copy per 64-row strip of the image's mask (8 KB at K = 1024) into
//   shared memory, each on its own mbarrier, so the scan of word 0 starts
//   while later strips land.  The scan then goes word by word: word w's
//   alive bits are its valid bits less those removed by earlier words; the
//   64 diagonal words mask[64w + b][w] are loaded into registers (loads
//   independent of the chain) and an unrolled 64-step register loop
//   resolves greedy NMS inside the word (two dependent ALU operations per
//   step, no shuffle and no memory access in the chain; skipped when no
//   diagonal word has a bit); then every lane l > w ORs mask[64w + b][l]
//   over the kept b, 64 independent loads that pipeline.
//   Lane l owns the removed bits of word l.  This equals the sequential
//   candidate-by-candidate scan exactly: candidate 64w + b is decided by
//   the rows of kept candidates before it, all of which are in words < w
//   (already ORed into removed) or in word w before b (the register loop).
//
// Measured by chip_smoke.py on the same card at N = 16, K = 1024: 0.036 ms
// on the detector's boxes (mask pass 23.3 us, scan 13.0 us; no pair of
// those boxes overlaps, so the in-word chain is skipped) and 0.047 ms on
// overlapping random boxes (scan 19.6 us with the chain).  Both passes
// remain far above the operation bound (2.5 us); likely causes, not
// measured (the machine has no ncu): the mask pass's blocks are short and
// wait on their first loads, and each scan word waits on 160 shared loads.
//
// Exactness: build without fast math (IEEE division) and with -fmad=false,
// so no product and sum contract into an FMA that rounds differently from
// the plain PyTorch version; the order of operations is the JAX one
// (union = (area_i + area_j) - inter, then max(union, 1e-12), then the
// quotient compared with thr).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaskThreads = 256;
constexpr int kMaxWords = 16;  // K <= 1024

// IoU(i, j) > thr in the reference's order of operations, with NaN-dropping
// fmaxf/fminf where the reference propagates NaN.  Exact all the same: a NaN
// coordinate, or an inf - inf in a width (both boxes' edges at the same
// infinity, so one box spans inf - inf), makes that box's area NaN, and
// the NaN-propagating max of the union carries it into the quotient, which
// then compares false as the reference's NaN IoU does.
__device__ __forceinline__ bool iou_gt(float4 bi, float ai, float4 bj, float aj,
                                       float thr) {
  const float ix1 = fmaxf(bi.x, bj.x);
  const float iy1 = fmaxf(bi.y, bj.y);
  const float ix2 = fminf(bi.z, bj.z);
  const float iy2 = fminf(bi.w, bj.w);
  const float iw = fmaxf(__fadd_rn(__fsub_rn(ix2, ix1), 1.0f), 0.0f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(iy2, iy1), 1.0f), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float u = __fsub_rn(__fadd_rn(ai, aj), inter);
  const float uni = u < 1e-12f ? 1e-12f : u;  // max(u, 1e-12), NaN kept
  return __fdiv_rn(inter, uni) > thr;
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes, unsigned long long* __restrict__ mask,
                int k, int words, int kpad, float thr) {
  // Upper-triangle tile t -> (row tile rt, column tile ct >= rt).
  int rt = 0, ct = blockIdx.x;
  while (ct >= words - rt) {
    ct -= words - rt;
    ++rt;
  }
  ct += rt;
  const float4* b = boxes + (size_t)blockIdx.y * k;

  // Boxes past K get a NaN area, so their pairs compare false.
  const float4 none = make_float4(0.f, 0.f, __int_as_float(0x7fc00000), 0.f);
  __shared__ float4 rb[kTile];
  __shared__ float ra[kTile];
  const int tid = threadIdx.x;
  if (tid < kTile) {
    const int i = rt * kTile + tid;
    const float4 v = i < k ? b[i] : none;
    rb[tid] = v;
    ra[tid] = area_of(v);
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Lane l tests columns 64ct + l and 64ct + 32 + l: two independent pairs
  // per row.
  const int j0 = ct * kTile + lane;
  const int j1 = j0 + 32;
  const float4 b0 = j0 < k ? b[j0] : none;
  const float4 b1 = j1 < k ? b[j1] : none;
  const float a0 = area_of(b0);
  const float a1 = area_of(b1);
  __syncthreads();

  unsigned long long* out = mask + (size_t)blockIdx.y * kpad * words + ct;
#pragma unroll 4
  for (int r = warp; r < kTile; r += kMaskThreads / 32) {
    const int i = rt * kTile + r;
    const float4 bi = rb[r];
    const float ai = ra[r];
    const uint32_t lo = __ballot_sync(0xffffffffu, iou_gt(bi, ai, b0, a0, thr) && j0 > i);
    const uint32_t hi = __ballot_sync(0xffffffffu, iou_gt(bi, ai, b1, a1, thr) && j1 > i);
    if (lane == 0 && i < k) out[(size_t)i * words] = (static_cast<unsigned long long>(hi) << 32) | lo;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: an mbarrier that completes on one arrival (bulk_copy's) and
// the bytes that arrival announces.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: a TMA bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every waiting thread: returns once `bar` has completed its first phase.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int k, int words) {
  // Dynamic shared memory: the image's kpad*words mask words.
  extern __shared__ __align__(16) unsigned long long sm[];
  __shared__ __align__(8) unsigned long long bars[kMaxWords];
  __shared__ unsigned long long vwords[kMaxWords];
  __shared__ unsigned long long kept_words[kMaxWords];
  const int lane = threadIdx.x;
  const int kpad = words * kTile;
  const size_t n = blockIdx.x;
  const unsigned long long* m = mask + n * kpad * words;
  const uint32_t strip_bytes = kTile * words * 8;

  if (lane == 0) {
    for (int w = 0; w < words; ++w) mbar_init(&bars[w]);
    for (int w = 0; w < words; ++w) {
      bulk_copy(sm + (size_t)w * kTile * words, m + (size_t)w * kTile * words, strip_bytes,
                &bars[w]);
    }
  }
  // Valid bits, one 64-bit word per 64 candidates, while the strips land.
  const unsigned char* v = valid + n * k;
  for (int w = 0; w < words; ++w) {
    const int j = w * kTile + lane;
    const uint32_t lo = __ballot_sync(0xffffffffu, j < k && v[j]);
    const uint32_t hi = __ballot_sync(0xffffffffu, j + 32 < k && v[j + 32]);
    if (lane == 0) vwords[w] = ((unsigned long long)hi << 32) | lo;
  }
  __syncwarp();

  const int col = lane < words ? lane : words - 1;  // lanes >= words idle
  unsigned long long removed = 0;                   // word `lane`
  for (int w = 0; w < words; ++w) {
    const unsigned long long rw = __shfl_sync(0xffffffffu, removed, w);
    unsigned long long alive = vwords[w] & ~rw;
    mbar_wait(&bars[w]);
    const unsigned long long* strip = sm + (size_t)w * kTile * words;
    // Diagonal words mask[64w + b][w], which hold only bits above b: both
    // halves for b < 32, the high half for b >= 32.
    const uint32_t* diag = reinterpret_cast<const uint32_t*>(strip + w);
    uint32_t dlo[32], dhi[kTile];
    uint32_t any = 0;
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      dhi[b] = diag[2 * b * words + 1];
      if (b < 32) dlo[b] = diag[2 * b * words];
      any |= dhi[b] | (b < 32 ? dlo[b] : 0u);
    }
    uint32_t lo = static_cast<uint32_t>(alive);
    uint32_t hi = static_cast<uint32_t>(alive >> 32);
    if (any != 0) {  // uniform: no pair of this word overlaps, nothing to do
      // Greedy inside the word, a register chain of 64 steps.
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const bool kept = (lo >> b) & 1u;
        lo = kept ? lo & ~dlo[b] : lo;
        hi = kept ? hi & ~dhi[b] : hi;
      }
#pragma unroll
      for (int b = 32; b < kTile; ++b) {
        hi = ((hi >> (b - 32)) & 1u) ? hi & ~dhi[b] : hi;
      }
    }
    alive = (static_cast<unsigned long long>(hi) << 32) | lo;
    // Lane l ORs the rows of the kept candidates at its own column.
    unsigned long long acc = 0;
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const unsigned long long row = strip[b * words + col];
      acc |= ((alive >> b) & 1ull) ? row : 0ull;
    }
    if (lane > w && lane < words) removed |= acc;
    if (lane == 0) kept_words[w] = alive;
  }
  __syncwarp();

  unsigned char* out = keep + n * k;
  for (int j = lane; j < k; j += 32) out[j] = (kept_words[j >> 6] >> (j & 63)) & 1ull;
}

}  // namespace

// Launches both passes on `stream` without synchronising.  `mask` is
// caller-allocated scratch of n * (64 * ceil(k/64)) * ceil(k/64) words.
// Requires 1 <= k <= 1024 and n >= 1.  Returns cudaGetLastError() after the
// launches (0 = success).
extern "C" int fcpt_greedy_nms_mask(const float* boxes,
                                    const unsigned char* valid,
                                    unsigned long long* mask,
                                    unsigned char* keep, int n, int k,
                                    float thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + kTile - 1) / kTile;
  const int kpad = words * kTile;
  const dim3 grid(words * (words + 1) / 2, n);
  nms_mask_kernel<<<grid, kMaskThreads, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), mask, k,
      words, kpad, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)kpad * words * 8;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<n, 32, smem, s>>>(mask, valid, keep, k, words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fcpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
