// Batched bilinear affine warp of uint8 RGB sources into uint8 crops, and the
// two-dimensional gather it is built on, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/mosaic_gather_probe.py:kern, the Pallas probe
// of the gather a Pallas warp kernel would need (take_along_axis of an (h, w)
// f32 tile by (h, w) int32 indices along axis 0 or 1), and with it the JAX
// warp's index gathers (face_crop_plus_tpu/ops/warp.py: _window_gather and
// the per-neighbour gathers of warp_affine_batch), which the TPU toolchain
// could not build as a kernel.
//
// warp_affine_u8_kernel computes
//   to_uint8(warp_affine_batch(images, matrices, img_idx, output_size,
//                              border_mode, windows))
// of face_crop_plus_tpu_torch/ops/warp.py in one pass, from the inverse
// matrices (invert_affine runs outside, in plain PyTorch).  One thread per
// output pixel does its 3 channels; the grid is (pixel blocks, faces).  It
// follows the plain version's two branches:
//   * window branch (replicate, reflect_101, constant without windows): the
//     sample coordinate is remapped into the window (or gets a 1-pixel zero
//     ring for constant), then one 2x2 window is read;
//   * per-neighbour branch (reflect, wrap, constant with windows): each of
//     the four neighbours is remapped with cv2's discrete borderInterpolate.
// Both use the plain version's order of operations with every product and
// sum rounded on its own (__fmul_rn/__fadd_rn, and -fmad=false for the
// rest), so the f32 value before rounding can equal the plain version's bit
// for bit; rounding is half to even (rintf), then saturation to [0, 255].
// reflect_101's continuous remap reproduces torch.remainder as ATen computes
// it: fmodf, then the divisor added when the signs differ.
//
// What bounds it on this card: bytes.  It does ~60 f32 operations per output
// pixel and moves the uint8 crops written (F*Ho*Wo*3 B) plus the source bytes
// it reads (at most the whole source batch; the 2x2 windows of neighbouring
// output pixels overlap, so L1/L2 serve most reads).  At 3.35 TB/s, 512
// crops of 256^2 (100.7 MB) bound it at ~30 us.  This first version reads
// the window with __ldg byte loads and writes 3 bytes per thread, without
// staging tiles in shared memory: the simple form that is right.
//
// Non-finite coordinates (degenerate fits, the random-weight detector's NaN
// landmarks) and huge ones: every float-to-int conversion saturates into
// [-2^30, 2^30] (NaN to -2^30) and every index is clamped into the source
// before it is read, so no input makes a read leave the source.  Such rows
// have ok = False and are dropped downstream; their pixels are not compared.
// Offsets are 64-bit: F*Ho*Wo*3 passes 2^31 at F >= 10,923 for 256^2 crops.
//
// gather2d_kernel is K2's own computation: out[i, j] = src[idx[i, j], j]
// (axis 0) or src[i, idx[i, j]] (axis 1) for f32 (h, w) and int32 (h, w),
// one thread per element.  Indices are clamped into range so that the kernel
// stays memory-safe; the wrapper does not check them (that would need a
// device-to-host sync).  Bound: bytes (idx and out, plus the source elements
// read).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// Border modes, in the order of ops/warp.py:BORDER_MODES.
constexpr int kConstant = 0;
constexpr int kReplicate = 1;
constexpr int kReflect = 2;
constexpr int kWrap = 3;
constexpr int kReflect101 = 4;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// An already-floored float as an int, saturated into [-2^30, 2^30]; NaN
// gives -2^30.  Exact for every coordinate a finite fit produces.
__device__ __forceinline__ int to_index(float fl) {
  const float lim = 1073741824.0f;
  if (!(fl > -lim)) return -(1 << 30);
  if (fl > lim) return 1 << 30;
  return static_cast<int>(fl);
}

// Python-style integer modulus (result has the divisor's sign), n >= 1.
__device__ __forceinline__ int pymod(int i, int n) {
  int r = i % n;
  if (r != 0 && ((r < 0) != (n < 0))) r += n;
  return r;
}

// torch.remainder for f32 as ATen computes it.
__device__ __forceinline__ float remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = add(m, b);
  return m;
}

// NaN-propagating min/max (torch.minimum/maximum); fminf/fmaxf drop NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// ops/warp.py:_map_coord: continuous remap into [0, n-1].
__device__ __forceinline__ float map_coord(float s, int n, int mode) {
  const float nf = static_cast<float>(n);
  const float last = sub(nf, 1.0f);
  if (mode == kReplicate) return min_nan(max_nan(s, 0.0f), last);
  // reflect_101
  const float p = max_nan(mul(2.0f, last), 1.0f);
  const float sm = remainder(s, p);
  if (nf <= 1.0f) return 0.0f;
  return sm > last ? sub(p, sm) : sm;
}

// ops/warp.py:_map_index: cv2 borderInterpolate of an int index into [0, n).
__device__ __forceinline__ int map_index(int i, int n, int mode) {
  n = n < 1 ? 1 : n;
  if (mode == kWrap) return pymod(i, n);
  if (mode == kReflect) {
    const int p = 2 * n;
    const int j = pymod(i, p);
    return j >= n ? p - 1 - j : j;
  }
  if (mode == kReflect101) {
    const int p = max(2 * n - 2, 1);
    const int j = pymod(i, p);
    return j >= n ? p - j : j;
  }
  return clampi(i, 0, n - 1);  // constant (masked by the caller), replicate
}

__device__ __forceinline__ void load3(const uint8_t* __restrict__ img, int w,
                                      int y, int x, float v[3]) {
  const uint8_t* p = img + (static_cast<size_t>(y) * w + x) * 3;
  v[0] = static_cast<float>(__ldg(p));
  v[1] = static_cast<float>(__ldg(p + 1));
  v[2] = static_cast<float>(__ldg(p + 2));
}

__device__ __forceinline__ uint8_t to_u8(float x) {
  const float r = rintf(x);  // half to even, as torch.round
  return static_cast<uint8_t>(fminf(fmaxf(r, 0.0f), 255.0f));  // NaN -> 0
}

__global__ void __launch_bounds__(kThreads)
warp_affine_u8_kernel(const uint8_t* __restrict__ src,
                      const float* __restrict__ inv,
                      const int* __restrict__ img_idx,
                      const int* __restrict__ windows,
                      uint8_t* __restrict__ out, int n, int h, int w, int f,
                      int ho, int wo, int mode) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= ho * wo) return;
  const float gx = static_cast<float>(pix % wo);
  const float gy = static_cast<float>(pix / wo);
  const bool windowed = windows != nullptr;
  const bool window_branch =
      mode == kReplicate || mode == kReflect101 ||
      (mode == kConstant && !windowed);

  for (int face = blockIdx.y; face < f; face += gridDim.y) {
    const float* m = inv + static_cast<size_t>(face) * 6;
    // _source_coords: (a*gx + b*gy) + c.
    const float sx = add(add(mul(__ldg(m), gx), mul(__ldg(m + 1), gy)), __ldg(m + 2));
    const float sy = add(add(mul(__ldg(m + 3), gx), mul(__ldg(m + 4), gy)), __ldg(m + 5));
    const int b = clampi(__ldg(img_idx + face), 0, n - 1);
    const uint8_t* img = src + static_cast<size_t>(b) * h * w * 3;
    int top = 0, left = 0, eh = h, ew = w;
    if (windowed) {
      const int* win = windows + static_cast<size_t>(face) * 4;
      top = __ldg(win);
      left = __ldg(win + 1);
      eh = __ldg(win + 2);
      ew = __ldg(win + 3);
    }

    float acc[3];
    if (window_branch) {
      float fx, fy;
      int ys, xs;
      bool inside = true;
      bool ring = false;  // constant: sample a 1-pixel zero ring
      if (mode == kConstant) {
        inside = (sx > -1.0f) && (sx < static_cast<float>(w)) &&
                 (sy > -1.0f) && (sy < static_cast<float>(h));
        const float x0 = floorf(sx);
        const float y0 = floorf(sy);
        fx = sub(sx, x0);
        fy = sub(sy, y0);
        // Padded coordinates in [0, H+1] x [0, W+1]; start <= H, W.
        ys = clampi(to_index(y0) + 1, 0, h);
        xs = clampi(to_index(x0) + 1, 0, w);
        ring = true;
      } else {
        const float sxm = map_coord(sx, ew, mode);
        const float sym = map_coord(sy, eh, mode);
        const int x0 = max(min(to_index(floorf(sxm)), ew - 2), 0);
        const int y0 = max(min(to_index(floorf(sym)), eh - 2), 0);
        fx = sub(sxm, static_cast<float>(x0));
        fy = sub(sym, static_cast<float>(y0));
        // Clamp the absolute window start into the image and carry the
        // shift into the bilinear fraction.
        const int ys_raw = y0 + top;
        const int xs_raw = x0 + left;
        ys = clampi(ys_raw, 0, max(h - 2, 0));
        xs = clampi(xs_raw, 0, max(w - 2, 0));
        fy = add(fy, static_cast<float>(ys_raw - ys));
        fx = add(fx, static_cast<float>(xs_raw - xs));
      }
      float v[4][3];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int y = ys + (q >> 1);
        int x = xs + (q & 1);
        if (ring) {  // padded (y, x) -> source (y - 1, x - 1), zero outside
          y -= 1;
          x -= 1;
          if (y < 0 || y >= h || x < 0 || x >= w) {
            v[q][0] = v[q][1] = v[q][2] = 0.0f;
            continue;
          }
        }
        load3(img, w, min(y, h - 1), min(x, w - 1), v[q]);
      }
      const float ofx = sub(1.0f, fx);
      const float ofy = sub(1.0f, fy);
      const float w00 = mul(ofx, ofy);
      const float w01 = mul(fx, ofy);
      const float w10 = mul(ofx, fy);
      const float w11 = mul(fx, fy);
      const float mask = inside ? 1.0f : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float o = add(add(add(mul(v[0][c], w00), mul(v[1][c], w01)),
                          mul(v[2][c], w10)),
                      mul(v[3][c], w11));
        acc[c] = ring ? mul(o, mask) : o;
      }
    } else {
      const float x0f = floorf(sx);
      const float y0f = floorf(sy);
      const float fx = sub(sx, x0f);
      const float fy = sub(sy, y0f);
      const int x0 = to_index(x0f);
      const int y0 = to_index(y0f);
      acc[0] = acc[1] = acc[2] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int dy = q >> 1;
        const int dx = q & 1;
        const int xi = x0 + dx;
        const int yi = y0 + dy;
        const int xm = clampi(map_index(xi, ew, mode) + left, 0, w - 1);
        const int ym = clampi(map_index(yi, eh, mode) + top, 0, h - 1);
        float wgt = mul(dx ? fx : sub(1.0f, fx), dy ? fy : sub(1.0f, fy));
        if (mode == kConstant) {
          const bool ok = xi >= 0 && xi < ew && yi >= 0 && yi < eh;
          wgt = mul(wgt, ok ? 1.0f : 0.0f);
        }
        float v[3];
        load3(img, w, ym, xm, v);
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = add(acc[c], mul(v[c], wgt));
      }
    }

    uint8_t* o = out + (static_cast<size_t>(face) * ho * wo + pix) * 3;
    o[0] = to_u8(acc[0]);
    o[1] = to_u8(acc[1]);
    o[2] = to_u8(acc[2]);
  }
}

__global__ void __launch_bounds__(kThreads)
gather2d_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                float* __restrict__ out, int h, int w, int axis) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(h) * w) return;
  const int i = static_cast<int>(e / w);
  const int j = static_cast<int>(e % w);
  const int k = __ldg(idx + e);
  const size_t from = axis == 0
                          ? static_cast<size_t>(clampi(k, 0, h - 1)) * w + j
                          : static_cast<size_t>(i) * w + clampi(k, 0, w - 1);
  out[e] = __ldg(src + from);
}

}  // namespace

// Launches the warp on `stream` without synchronising.  src: uint8
// (n, h, w, 3); inv: f32 (f, 2, 3) inverse matrices; img_idx: int32 (f,);
// windows: int32 (f, 4) (top, left, height, width) or null; out: uint8
// (f, ho, wo, 3).  Requires n, h, w, f, ho, wo >= 1.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int fcpt_warp_affine_u8(const uint8_t* src, const float* inv,
                                   const int* img_idx, const int* windows,
                                   uint8_t* out, int n, int h, int w, int f,
                                   int ho, int wo, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pixels = ho * wo;
  const dim3 grid((pixels + kThreads - 1) / kThreads,
                  f < kMaxGridY ? f : kMaxGridY);
  warp_affine_u8_kernel<<<grid, kThreads, 0, s>>>(src, inv, img_idx, windows,
                                                  out, n, h, w, f, ho, wo,
                                                  mode);
  return static_cast<int>(cudaGetLastError());
}

// Launches gather2d on `stream` without synchronising; h, w >= 1, axis 0 or
// 1.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int fcpt_gather2d(const float* src, const int* idx, float* out,
                             int h, int w, int axis, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(h) * w;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  gather2d_kernel<<<blocks, kThreads, 0, s>>>(src, idx, out, h, w, axis);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fcpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
