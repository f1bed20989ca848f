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
// warp_affine_u8_kernel<MODE, WINDOWED> computes
//   to_uint8(warp_affine_batch(images, matrices, img_idx, output_size,
//                              border_mode, windows))
// of face_crop_plus_tpu_torch/ops/warp.py in one pass, from the forward
// matrices.  It follows the plain version's two branches:
//   * window branch (replicate, reflect_101, constant without windows): the
//     sample coordinate is remapped into the window (or gets a 1-pixel zero
//     ring for constant), then one 2x2 window is read;
//   * per-neighbour branch (reflect, wrap, constant with windows): each of
//     the four neighbours is remapped with cv2's discrete borderInterpolate.
// Both use the plain version's order of operations with every product, sum
// and quotient rounded on its own (__fmul_rn/__fadd_rn/__fdiv_rn, and
// -fmad=false for the rest), so the f32 value before rounding equals the
// plain version's bit for bit; rounding is half to even, then saturation to
// [0, 255] (to_u8).  reflect_101's continuous remap reproduces
// torch.remainder as ATen computes it: fmodf, then the divisor added when
// the signs differ.
//
// What bounds it on this card.  Bytes would allow ~0.031 ms for one
// strategy-"all" chunk (512 crops of 256² from 16 sources of 218x178:
// 100.7 MB written, the source read once).  The first version, one thread
// per output pixel, took 0.388 ms there on an H100 80GB HBM3 (700 W), 1.4x
// F.grid_sample, which moves 6.5x the bytes (f32 grid and output) in
// 0.275 ms: it was held back by instructions and memory transactions per
// pixel (12 one-byte loads, 3 one-byte stores at a 3-byte stride, run-time
// branches on the mode, 64-bit index arithmetic), not by bytes.  This
// design:
//   * the border mode and the presence of windows are template parameters
//     (10 instantiations, picked by the launcher): no per-pixel branch on
//     them;
//   * each block inverts its face's matrix once, exactly as
//     ops/transform.py:invert_affine does (ATen's separate roundings and
//     sign-preserving epsilon), and shares it through shared memory: the
//     wrapper launches nothing else;
//   * each thread computes 8 output pixels 256 apart (each coordinate
//     (a*gx + b*gy) + c computed whole, never stepped), so that a warp's
//     lanes gather for neighbouring pixels, and stores their bytes into a
//     shared-memory tile of 2,048 pixels; the block writes the tile's
//     contiguous bytes with aligned 16-byte stores (funnel shifts realign
//     the tile to the destination; the unaligned head and tail of a tile
//     go byte by byte);
//   * each 2-pixel window row (6 bytes) is read with two or three aligned
//     32-bit loads and funnel shifts instead of six byte loads, and the
//     zero ring of constant mode is made by shifting the words, not by
//     branches; offsets inside one image are 32-bit;
//   * no quarter-rate conversion where a full-rate operation does the same:
//     bytes become floats through the mantissa (byte_f), the rounding to
//     uint8 through an add (to_u8), and the output coordinates are stepped
//     as exact floats;
//   * in constant mode a sample outside the 1-pixel ring is 0 with no read
//     and no blend (many samples of minified or off-image faces).
// Measured on an H100 80GB HBM3 (700 W) by chip_smoke.py: 0.145 ms at that
// chunk shape, 4.7x its bytes bound and 1.9x faster than F.grid_sample; the
// remaining time goes to issuing instructions (the plain version's f32
// arithmetic, rounded operation by operation, plus index and byte
// handling), not to moving bytes.
//
// Non-finite coordinates (degenerate fits, the random-weight detector's NaN
// landmarks) and huge ones: every float-to-int conversion saturates into
// [-2^30, 2^30] (NaN to -2^30) and every index is clamped into the source
// before it is read, so no input makes a read leave the source.  Such rows
// have ok = False and are dropped downstream; their pixels are not compared.
// Face and image offsets are 64-bit (F*Ho*Wo*3 passes 2^31 at F >= 10,923
// for 256^2 crops), offsets inside one image or one crop 32-bit (the wrapper
// holds each below 2^31 bytes); faces past 65,535 are taken by a grid-stride
// loop.
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
constexpr int kPix = 8;                      // output pixels a thread
constexpr int kTilePix = kThreads * kPix;    // output pixels a block
constexpr int kTileWords = kTilePix * 3 / 4; // their bytes, as 32-bit words

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
// gives -2^30 (fmaxf drops it).  Exact for every coordinate a finite fit
// produces.
__device__ __forceinline__ int to_index(float fl) {
  const float lim = 1073741824.0f;
  return __float2int_rz(fminf(fmaxf(fl, -lim), lim));
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
template <int MODE>
__device__ __forceinline__ float map_coord(float s, int n) {
  const float nf = static_cast<float>(n);
  const float last = sub(nf, 1.0f);
  if (MODE == kReplicate) return min_nan(max_nan(s, 0.0f), last);
  // reflect_101
  const float p = max_nan(mul(2.0f, last), 1.0f);
  const float sm = remainder(s, p);
  if (nf <= 1.0f) return 0.0f;
  return sm > last ? sub(p, sm) : sm;
}

// ops/warp.py:_map_index: cv2 borderInterpolate of an int index into [0, n).
template <int MODE>
__device__ __forceinline__ int map_index(int i, int n) {
  n = n < 1 ? 1 : n;
  if (MODE == kWrap) return pymod(i, n);
  if (MODE == kReflect) {
    const int p = 2 * n;
    const int j = pymod(i, p);
    return j >= n ? p - 1 - j : j;
  }
  if (MODE == kReflect101) {
    const int p = max(2 * n - 2, 1);
    const int j = pymod(i, p);
    return j >= n ? p - j : j;
  }
  return clampi(i, 0, n - 1);  // constant (masked by the caller), replicate
}

// Byte b of `word` as an exact float without an int-to-float conversion
// (a quarter-rate instruction on this card): the byte becomes the low
// mantissa bits of 2^23 + byte, and 2^23 is subtracted exactly.
__device__ __forceinline__ float byte_f(uint32_t word, uint32_t b) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | b)), 8388608.0f);
}

// One source image, read as aligned 32-bit words: byte `off` of the image
// is byte (a0 + off) & 3 of word (a0 + off) >> 2.  Offsets are 32-bit (the
// wrapper holds every image below 2^31 bytes).  An aligned word that holds
// one byte of the image lies inside its allocation.
struct Src {
  const uint32_t* words;
  uint32_t a0;
};

__device__ __forceinline__ Src image_src(const uint8_t* img) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(img);
  return {reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3)), static_cast<uint32_t>(a & 3)};
}

// The 6 bytes at `off` (two adjacent pixels), from two or three aligned
// loads: bytes 0-3 in lo, 4-5 in the low half of hi.
__device__ __forceinline__ void load6_words(const Src& s, int off, uint32_t& lo, uint32_t& hi) {
  const uint32_t t = s.a0 + static_cast<uint32_t>(off);
  const uint32_t* p = s.words + (t >> 2);
  const uint32_t r = (t & 3) * 8;
  const uint32_t w0 = __ldg(p);
  const uint32_t w1 = __ldg(p + 1);
  const uint32_t w2 = r == 24 ? __ldg(p + 2) : 0u;
  lo = __funnelshift_r(w0, w1, r);
  hi = __funnelshift_r(w1, w2, r);
}

__device__ __forceinline__ void unpack6(uint32_t lo, uint32_t hi, float v0[3], float v1[3]) {
  v0[0] = byte_f(lo, 0);
  v0[1] = byte_f(lo, 1);
  v0[2] = byte_f(lo, 2);
  v1[0] = byte_f(lo, 3);
  v1[1] = byte_f(hi, 0);
  v1[2] = byte_f(hi, 1);
}

// The 3 bytes at `off` as floats, from one or two aligned loads.
__device__ __forceinline__ void load3(const Src& s, int off, float v[3]) {
  const uint32_t t = s.a0 + static_cast<uint32_t>(off);
  const uint32_t* p = s.words + (t >> 2);
  const uint32_t r = (t & 3) * 8;
  const uint32_t w0 = __ldg(p);
  const uint32_t w1 = r >= 16 ? __ldg(p + 1) : 0u;
  const uint32_t lo = __funnelshift_r(w0, w1, r);
  v[0] = byte_f(lo, 0);
  v[1] = byte_f(lo, 1);
  v[2] = byte_f(lo, 2);
}

// Pixels x0 and x1 of the source row starting at byte `row` (x0, x1
// already inside the row).
__device__ __forceinline__ void load_pair(const Src& s, int row, int x0, int x1,
                                          float v0[3], float v1[3]) {
  if (x1 == x0 + 1) {
    uint32_t lo, hi;
    load6_words(s, row + 3 * x0, lo, hi);
    unpack6(lo, hi, v0, v1);
  } else {
    load3(s, row + 3 * x0, v0);
    load3(s, row + 3 * x1, v1);
  }
}

// Row yy, pixels x and x + 1, of the source with a 1-pixel zero ring
// (yy in [-1, h], x in [-1, w - 1]; w >= 2), without a branch: the pair at
// the clamped column is read and shifted by one pixel at either edge.
__device__ __forceinline__ void ring_pair(const Src& s, int h, int w, int yy, int x,
                                          float v0[3], float v1[3]) {
  uint32_t lo, hi;
  load6_words(s, (clampi(yy, 0, h - 1) * w + clampi(x, 0, w - 2)) * 3, lo, hi);
  if (x < 0) {  // (0, pixel 0)
    hi = lo >> 8;
    lo <<= 24;
  } else if (x > w - 2) {  // (pixel w - 1, 0)
    lo = __funnelshift_r(lo, hi, 24) & 0xffffffu;
    hi = 0u;
  }
  if (yy < 0 || yy >= h) lo = hi = 0u;
  unpack6(lo, hi, v0, v1);
}

// clamp(round(x), 0, 255) with round half to even, as torch.round, without
// a rounding or float-to-int conversion instruction: clamping first gives
// the same result (the bounds are integers), and adding 1.5 * 2^23 rounds
// [0, 255] to an integer held in the low mantissa bits.  NaN gives 0.
__device__ __forceinline__ uint32_t to_u8(float x) {
  const float c = fminf(fmaxf(x, 0.0f), 255.0f);
  return __float_as_uint(__fadd_rn(c, 12582912.0f)) & 0xffu;
}

// One face: its inverse matrix (ops/transform.py:invert_affine, every
// operation rounded as ATen rounds it), source image and window.
struct Face {
  float inv[6];
  int b, top, left, eh, ew;
};

__device__ __forceinline__ void load_face(const float* __restrict__ mats,
                                          const int* __restrict__ img_idx,
                                          const int* __restrict__ windows,
                                          int face, int n, int h, int w, Face* out) {
  const float* m = mats + static_cast<size_t>(face) * 6;
  const float a = m[0], b = m[1], tx = m[2];
  const float c = m[3], d = m[4], ty = m[5];
  float det = sub(mul(a, d), mul(b, c));
  // Sign-preserving epsilon (torch.where(det < 0, -1e-12, 1e-12) in f32).
  const float eps = det < 0.0f ? -1e-12f : 1e-12f;
  if (fabsf(det) < 1e-12f) det = eps;
  const float ia = __fdiv_rn(d, det), ib = __fdiv_rn(-b, det);
  const float ic = __fdiv_rn(-c, det), id = __fdiv_rn(a, det);
  out->inv[0] = ia;
  out->inv[1] = ib;
  out->inv[2] = -add(mul(ia, tx), mul(ib, ty));
  out->inv[3] = ic;
  out->inv[4] = id;
  out->inv[5] = -add(mul(ic, tx), mul(id, ty));
  out->b = clampi(img_idx[face], 0, n - 1);
  if (windows != nullptr) {
    const int* win = windows + static_cast<size_t>(face) * 4;
    out->top = win[0];
    out->left = win[1];
    out->eh = win[2];
    out->ew = win[3];
  } else {
    out->top = 0;
    out->left = 0;
    out->eh = h;
    out->ew = w;
  }
}

// The f32 value of one output pixel at source coordinate (sx, sy).
template <int MODE, bool WINDOWED>
__device__ __forceinline__ void sample(const Src& img, int h, int w, const Face& fc,
                                       float sx, float sy, float acc[3]) {
  constexpr bool kWindowBranch =
      MODE == kReplicate || MODE == kReflect101 || (MODE == kConstant && !WINDOWED);
  const int row_bytes = w * 3;
  if (kWindowBranch) {
    float v[4][3];
    float fx, fy;
    float mask = 1.0f;
    if (MODE == kConstant) {
      const bool inside = (sx > -1.0f) && (sx < static_cast<float>(w)) &&
                          (sy > -1.0f) && (sy < static_cast<float>(h));
      mask = inside ? 1.0f : 0.0f;
      const float x0 = floorf(sx);
      const float y0 = floorf(sy);
      fx = sub(sx, x0);
      fy = sub(sy, y0);
      // Padded start in [0, H] x [0, W]; padded (y, x) is source
      // (y - 1, x - 1), zero outside (the 1-pixel ring).
      const int y = clampi(to_index(y0) + 1, 0, h) - 1;
      const int x = clampi(to_index(x0) + 1, 0, w) - 1;
      if (!inside) {
        // A sample outside the ring is 0 (the plain version's o * 0, with
        // o finite for a finite matrix): no read, no blend.
        acc[0] = acc[1] = acc[2] = 0.0f;
        return;
      }
      if (w >= 2) {  // uniform
        ring_pair(img, h, w, y, x, v[0], v[1]);
        ring_pair(img, h, w, y + 1, x, v[2], v[3]);
      } else {  // a one-column source: pixel x = 0 or nothing
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int yy = y + (q >> 1);
          const int xx = x + (q & 1);
          if (yy < 0 || yy >= h || xx != 0) {
            v[q][0] = v[q][1] = v[q][2] = 0.0f;
          } else {
            load3(img, yy * row_bytes, v[q]);
          }
        }
      }
    } else {
      const float sxm = map_coord<MODE>(sx, fc.ew);
      const float sym = map_coord<MODE>(sy, fc.eh);
      const int x0 = max(min(to_index(floorf(sxm)), fc.ew - 2), 0);
      const int y0 = max(min(to_index(floorf(sym)), fc.eh - 2), 0);
      fx = sub(sxm, static_cast<float>(x0));
      fy = sub(sym, static_cast<float>(y0));
      // Clamp the absolute window start into the image and carry the
      // shift into the bilinear fraction.
      const int ys_raw = y0 + fc.top;
      const int xs_raw = x0 + fc.left;
      const int ys = clampi(ys_raw, 0, max(h - 2, 0));
      const int xs = clampi(xs_raw, 0, max(w - 2, 0));
      fy = add(fy, static_cast<float>(ys_raw - ys));
      fx = add(fx, static_cast<float>(xs_raw - xs));
      const int x1 = min(xs + 1, w - 1);
      load_pair(img, ys * row_bytes, xs, x1, v[0], v[1]);
      load_pair(img, min(ys + 1, h - 1) * row_bytes, xs, x1, v[2], v[3]);
    }
    const float ofx = sub(1.0f, fx);
    const float ofy = sub(1.0f, fy);
    const float w00 = mul(ofx, ofy);
    const float w01 = mul(fx, ofy);
    const float w10 = mul(ofx, fy);
    const float w11 = mul(fx, fy);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float o = add(add(add(mul(v[0][c], w00), mul(v[1][c], w01)),
                              mul(v[2][c], w10)),
                          mul(v[3][c], w11));
      acc[c] = MODE == kConstant ? mul(o, mask) : o;
    }
  } else {
    const float x0f = floorf(sx);
    const float y0f = floorf(sy);
    const float fx = sub(sx, x0f);
    const float fy = sub(sy, y0f);
    const int x0 = to_index(x0f);
    const int y0 = to_index(y0f);
    const int xm0 = clampi(map_index<MODE>(x0, fc.ew) + fc.left, 0, w - 1);
    const int xm1 = clampi(map_index<MODE>(x0 + 1, fc.ew) + fc.left, 0, w - 1);
    acc[0] = acc[1] = acc[2] = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yi = y0 + dy;
      const int ym = clampi(map_index<MODE>(yi, fc.eh) + fc.top, 0, h - 1);
      float v[2][3];
      load_pair(img, ym * row_bytes, xm0, xm1, v[0], v[1]);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xi = x0 + dx;
        float wgt = mul(dx ? fx : sub(1.0f, fx), dy ? fy : sub(1.0f, fy));
        if (MODE == kConstant) {
          const bool ok = xi >= 0 && xi < fc.ew && yi >= 0 && yi < fc.eh;
          wgt = mul(wgt, ok ? 1.0f : 0.0f);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = add(acc[c], mul(v[dx][c], wgt));
      }
    }
  }
}

// Grid: (tiles of kTilePix output pixels of one face, faces).  Thread t
// computes pixels t, t + 256, t + 512, ... of its block's tile, so that the
// lanes of a warp sample neighbouring output pixels.
template <int MODE, bool WINDOWED>
__global__ void __launch_bounds__(kThreads)
warp_affine_u8_kernel(const uint8_t* __restrict__ src,
                      const float* __restrict__ mats,
                      const int* __restrict__ img_idx,
                      const int* __restrict__ windows,
                      uint8_t* __restrict__ out, int n, int h, int w, int f,
                      int ho, int wo) {
  // 4 words past the tile: the copy-out reads one word beyond its last
  // 16-byte chunk.
  __shared__ __align__(16) uint32_t tile[kTileWords + 4];
  __shared__ Face face_s;
  const int t = threadIdx.x;
  const int npix = ho * wo;
  const int p0 = blockIdx.x * kTilePix;
  const int cnt = min(kTilePix, npix - p0);
  // Output coordinates as floats, stepped exactly (integers below 2^24).
  const int y_first = (p0 + t) / wo;
  const float gx_first = static_cast<float>(p0 + t - y_first * wo);
  const float gy_first = static_cast<float>(y_first);
  const float wo_f = static_cast<float>(wo);
  const float y_step = static_cast<float>(kThreads / wo);
  const float x_step = static_cast<float>(kThreads % wo);
  const size_t img_bytes = static_cast<size_t>(h) * w * 3;
  uint8_t* tb = reinterpret_cast<uint8_t*>(tile);

  for (int face = blockIdx.y; face < f; face += gridDim.y) {
    if (t == 0) load_face(mats, img_idx, WINDOWED ? windows : nullptr, face, n, h, w, &face_s);
    __syncthreads();
    const Face fc = face_s;
    const Src img = image_src(src + fc.b * img_bytes);

    float gx = gx_first, gy = gy_first;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int q = t + k * kThreads;
      if (q < cnt) {
        // _source_coords: (a*gx + b*gy) + c, whole for every pixel.
        const float sx = add(add(mul(fc.inv[0], gx), mul(fc.inv[1], gy)), fc.inv[2]);
        const float sy = add(add(mul(fc.inv[3], gx), mul(fc.inv[4], gy)), fc.inv[5]);
        float acc[3];
        sample<MODE, WINDOWED>(img, h, w, fc, sx, sy, acc);
#pragma unroll
        for (int c = 0; c < 3; ++c) tb[3 * q + c] = static_cast<uint8_t>(to_u8(acc[c]));
      }
      gx = add(gx, x_step);
      gy = add(gy, y_step);
      if (gx >= wo_f) {
        gx = sub(gx, wo_f);
        gy = add(gy, 1.0f);
      }
    }
    __syncthreads();

    // Copy the tile's 3*cnt contiguous bytes out: byte stores up to the
    // first 16-byte boundary of the destination, 16-byte stores, byte
    // stores for the tail.
    uint8_t* g = out + (static_cast<size_t>(face) * npix + p0) * 3;
    const int bytes = 3 * cnt;
    const int head = min(static_cast<int>((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15), bytes);
    if (t < head) g[t] = tb[t];
    const int nvec = (bytes - head) >> 4;
    const uint32_t shift = static_cast<uint32_t>(head & 3) * 8;
    for (int v = t; v < nvec; v += kThreads) {
      const int o = head + 16 * v;
      const uint32_t* s = tile + (o >> 2);
      const uint32_t s0 = s[0], s1 = s[1], s2 = s[2], s3 = s[3], s4 = s[4];
      uint4 val;
      val.x = __funnelshift_r(s0, s1, shift);
      val.y = __funnelshift_r(s1, s2, shift);
      val.z = __funnelshift_r(s2, s3, shift);
      val.w = __funnelshift_r(s3, s4, shift);
      *reinterpret_cast<uint4*>(g + o) = val;
    }
    const int tail = head + 16 * nvec;
    if (t < bytes - tail) g[tail + t] = tb[tail + t];
    if (face + gridDim.y < f) __syncthreads();  // the tile is reused
  }
}

template <int MODE, bool WINDOWED>
int launch_warp(const uint8_t* src, const float* mats, const int* img_idx,
                const int* windows, uint8_t* out, int n, int h, int w, int f,
                int ho, int wo, cudaStream_t s) {
  const dim3 grid((ho * wo + kTilePix - 1) / kTilePix, f < kMaxGridY ? f : kMaxGridY);
  warp_affine_u8_kernel<MODE, WINDOWED><<<grid, kThreads, 0, s>>>(
      src, mats, img_idx, windows, out, n, h, w, f, ho, wo);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(const uint8_t* src, const float* mats, const int* img_idx,
                const int* windows, uint8_t* out, int n, int h, int w, int f,
                int ho, int wo, cudaStream_t s) {
  if (windows != nullptr) {
    return launch_warp<MODE, true>(src, mats, img_idx, windows, out, n, h, w, f, ho, wo, s);
  }
  return launch_warp<MODE, false>(src, mats, img_idx, windows, out, n, h, w, f, ho, wo, s);
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
// (n, h, w, 3); mats: f32 (f, 2, 3) forward matrices (source → crop);
// img_idx: int32 (f,); windows: int32 (f, 4) (top, left, height, width) or
// null; out: uint8 (f, ho, wo, 3).  Requires n, h, w, f, ho, wo >= 1 and
// mode in [0, 5).  Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int fcpt_warp_affine_u8(const uint8_t* src, const float* mats,
                                   const int* img_idx, const int* windows,
                                   uint8_t* out, int n, int h, int w, int f,
                                   int ho, int wo, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kConstant:
      return launch_mode<kConstant>(src, mats, img_idx, windows, out, n, h, w, f, ho, wo, s);
    case kReplicate:
      return launch_mode<kReplicate>(src, mats, img_idx, windows, out, n, h, w, f, ho, wo, s);
    case kReflect:
      return launch_mode<kReflect>(src, mats, img_idx, windows, out, n, h, w, f, ho, wo, s);
    case kWrap:
      return launch_mode<kWrap>(src, mats, img_idx, windows, out, n, h, w, f, ho, wo, s);
    case kReflect101:
      return launch_mode<kReflect101>(src, mats, img_idx, windows, out, n, h, w, f, ho, wo, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
