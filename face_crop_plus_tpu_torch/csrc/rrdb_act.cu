// The epilogue of RRDBNet's convolutions, hand-written for Hopper (sm_90a):
// the convolution's bias and what follows it in the enhancer, over an NCHW
// float32 tensor in one pass, written straight into its final place,
//
//   a = y[n, c, i] + b[c]
//   out[n, c, i] = a                                   kBias   (conv_first, conv_last)
//                  a > 0 ? a : a * 0.2                 kLeaky  (conv1-4, upconv1-2, HRconv)
//                  a + r[n, c, i]                      kAdd    (trunk_conv)
//                  (a * 0.2) + r[n, c, i]              kDense  (a dense block's conv5)
//                  ((a * 0.2) + r) * 0.2 + r2[n, c, i] kRrdb   (the third block's conv5)
//
// where y is the convolution's output computed without its bias, r the
// dense block's input and r2 the RRDB's input.
//
// Replaces no TPU kernel.  On the TPU, XLA fuses the bias, the activation and
// the scaled residuals into the convolutions and lays out the concatenation
// of a dense block itself; in PyTorch the bias rides in nn.Conv2d as an ATen
// add of its own after cuDNN, the LeakyReLU, each multiply by 0.2 and each
// residual add is another pass, and torch.cat copies the whole growing tensor
// after every growth convolution.  This kernel does the operations in one
// pass over the convolution's output and writes its result into a channel
// slice of a preallocated (N, 192, H, W) buffer, so the next convolution
// reads the concatenation where it already lies.
//
// Exactness: every operation is the plain version's (ATen's add of the bias
// after cuDNN, then face_crop_plus_tpu_torch/ops/nn.py: rrdb_act_plain), in
// its order, each rounded on its own: the bias by __fadd_rn as that add_, then
// LeakyReLU as ATen computes it (a > 0 ? a : a * 0.2f, so a NaN passes
// through the multiply), or each 0.2 (0.2f, as ATen casts the scalar) by
// __fmul_rn and each residual by __fadd_rn.  Built with -fmad=false besides,
// so nothing contracts into an FMA: the output equals the plain version's bit
// for bit.
//
// What bounds it on this card: bytes.  At most three multiplies and three adds
// an element against 8 bytes moved (12 with a residual, 16 with two), far
// below the card's ~20 operations a byte.  Its design, bn_act.cu's:
//   * the work is cut into units: a run of at most kSegment elements of one
//     (n, c) plane, whose H*W elements are contiguous in every tensor.  A warp
//     takes one unit, so the channel, its bias and the unit's offsets are
//     worked out once and held in registers;
//   * the run's body moves as aligned 16-byte vectors, kUnroll of them in
//     flight per lane and per tensor before the first store; a head of up to
//     3 elements (until y is 16-byte aligned) and a tail of up to 3 go one
//     element a lane.  The launcher takes the vector path when every base
//     pointer is 16-byte aligned and every batch stride keeps its tensor in
//     step with y; otherwise every element goes one a lane;
//   * y is contiguous; r, r2 and out are given by a pointer and a batch
//     stride, so each may be a channel slice of a larger NCHW tensor.  out may
//     be y itself, or r2 itself (the RRDB's output over its input): each
//     element is read before the same thread writes it;
//   * the form is a template parameter (10 instantiations with the vector
//     switch), so no element branches on it; offsets are 64-bit, computed
//     once a unit.
//
// Measured by chip_smoke.py phase 7 (g) on an H100 80GB HBM3 (700 W), the 351
// epilogues of one 1024^2 forward from a cold L2: 54.5 ms against 46.8 ms by
// bytes (156.9 GB), 86 % of the bound (82-91 % by shape); the ATen passes
// into the same slices take 171.0 ms.  The forward falls from 1526 to 1177 ms
// with the same output bits: the NCHW buffers also spare cuDNN the
// transposes it ran around the channels-last trunk's convolutions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Elements of one plane a warp walks (a multiple of 4): 32 float4 a lane.
constexpr long long kSegment = 4096;
constexpr int kUnroll = 4;
// The LeakyReLU's slope and the residuals' scale: ATen casts the Python
// scalar 0.2 to float.
constexpr float kPoint2 = 0.2f;

enum Form { kBias = 0, kLeaky = 1, kAdd = 2, kDense = 3, kRrdb = 4 };

struct Args {
  const float* y;
  const float* bias;
  const float* r;   // kAdd, kDense, kRrdb
  const float* r2;  // kRrdb
  float* out;
  int c;
  long long hw;
  long long r_gap;  // each tensor's batch stride less c * hw, in elements
  long long r2_gap;
  long long out_gap;
  long long units_per_plane;
  long long units;
};

template <int FORM>
__device__ __forceinline__ float epilogue(float y, float b, float r, float r2) {
  float a = __fadd_rn(y, b);
  if (FORM == kLeaky) return a > 0.0f ? a : __fmul_rn(a, kPoint2);
  if (FORM == kAdd) return __fadd_rn(a, r);
  if (FORM == kDense || FORM == kRrdb) a = __fadd_rn(__fmul_rn(a, kPoint2), r);
  if (FORM == kRrdb) a = __fadd_rn(__fmul_rn(a, kPoint2), r2);
  return a;
}

template <int FORM>
__device__ __forceinline__ float4 epilogue4(float4 y, float b, float4 r, float4 r2) {
  return make_float4(epilogue<FORM>(y.x, b, r.x, r2.x), epilogue<FORM>(y.y, b, r.y, r2.y),
                     epilogue<FORM>(y.z, b, r.z, r2.z), epilogue<FORM>(y.w, b, r.w, r2.w));
}

template <int FORM, bool VEC>
__global__ void __launch_bounds__(kThreads) rrdb_act_kernel(Args a) {
  constexpr bool kR = FORM >= kAdd;
  constexpr bool kR2 = FORM == kRrdb;
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (unit >= a.units) return;
  const int lane = threadIdx.x & 31;
  const long long p = unit / a.units_per_plane;  // plane n * c + channel
  const long long begin = (unit - p * a.units_per_plane) * kSegment;
  const long long len = min(kSegment, a.hw - begin);
  const long long n = p / a.c;
  const float b = a.bias[p - n * a.c];
  const long long off = p * a.hw + begin;
  const float* y = a.y + off;
  const float* r = kR ? a.r + off + n * a.r_gap : nullptr;
  const float* r2 = kR2 ? a.r2 + off + n * a.r2_gap : nullptr;
  float* o = a.out + off + n * a.out_gap;

  long long head = 0, body = 0;
  if (VEC) {
    head = min(static_cast<long long>((4 - (off & 3)) & 3), len);
    body = (len - head) >> 2;
  }
  // Scalar head (vector path) or the whole run (scalar path).
  const long long scalar_end = VEC ? head : len;
  for (long long j = lane; j < scalar_end; j += 32)
    o[j] = epilogue<FORM>(y[j], b, kR ? r[j] : 0.0f, kR2 ? r2[j] : 0.0f);
  if (!VEC) return;

  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* y4 = reinterpret_cast<const float4*>(y + head);
  const float4* r4 = kR ? reinterpret_cast<const float4*>(r + head) : nullptr;
  const float4* q4 = kR2 ? reinterpret_cast<const float4*>(r2 + head) : nullptr;
  float4* o4 = reinterpret_cast<float4*>(o + head);
  for (long long j = lane; j < body; j += 32 * kUnroll) {
    float4 yv[kUnroll], rv[kUnroll], qv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long q = j + 32 * k;
      if (q < body) {
        yv[k] = y4[q];
        rv[k] = kR ? r4[q] : zero;
        qv[k] = kR2 ? q4[q] : zero;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long q = j + 32 * k;
      if (q < body) o4[q] = epilogue4<FORM>(yv[k], b, rv[k], qv[k]);
    }
  }
  // Scalar tail.
  const long long tail = head + 4 * body;
  if (lane < len - tail) {
    const long long j = tail + lane;
    o[j] = epilogue<FORM>(y[j], b, kR ? r[j] : 0.0f, kR2 ? r2[j] : 0.0f);
  }
}

template <int FORM>
cudaError_t launch(const Args& a, bool vec, cudaStream_t s) {
  const long long blocks = (a.units + kWarps - 1) / kWarps;
  if (vec)
    rrdb_act_kernel<FORM, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  else
    rrdb_act_kernel<FORM, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches the epilogue on `stream` without synchronising.  y: n*c planes of
// hw contiguous floats; r, r2, out: the same planes at their batch strides
// (c * hw when contiguous).  form: 0 bias, 1 LeakyReLU, 2 + r, 3 0.2-scaled
// + r, 4 then 0.2-scaled + r2 (r and r2 may be null where the form reads
// none).  vec: every pointer is 16-byte aligned and, unless n == 1, every
// (batch stride - c * hw) % 4 == 0.  The launch is made on `device`, the
// stream's card, which is made current for it and then restored.  Requires
// n, c, hw >= 1 and fewer than 2^31 * 8 units.  Returns cudaGetLastError()
// after the launch (0 = success), or cudaErrorInvalidValue for an unknown
// form.
extern "C" int fcpt_rrdb_act(const float* y, const float* bias, const float* r,
                             const float* r2, float* out, long long n, int c, long long hw,
                             long long r_stride, long long r2_stride,
                             long long out_stride, int form, int vec, int device,
                             void* stream) {
  Args a;
  a.y = y;
  a.bias = bias;
  a.r = r;
  a.r2 = r2;
  a.out = out;
  a.c = c;
  a.hw = hw;
  const long long planes = static_cast<long long>(c) * hw;
  a.r_gap = r_stride - planes;
  a.r2_gap = r2_stride - planes;
  a.out_gap = out_stride - planes;
  a.units_per_plane = (hw + kSegment - 1) / kSegment;
  a.units = n * c * a.units_per_plane;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (form) {
    case kBias: err = launch<kBias>(a, v, s); break;
    case kLeaky: err = launch<kLeaky>(a, v, s); break;
    case kAdd: err = launch<kAdd>(a, v, s); break;
    case kDense: err = launch<kDense>(a, v, s); break;
    case kRrdb: err = launch<kRrdb>(a, v, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* fcpt_rrdb_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
