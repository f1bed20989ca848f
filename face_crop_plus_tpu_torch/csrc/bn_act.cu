// The epilogue of the detector's convolutions, hand-written for Hopper
// (sm_90a): folded inference BatchNorm, an optional residual and an optional
// ReLU over an NCHW float32 tensor in one pass,
//
//   y[n, c, i] = act((x[n, c, i] * s[c] + b[c]) + r[n, c, i])
//
// where the residual r is absent, a plain tensor (a bottleneck's identity),
// or a second folded BatchNorm u[n, c, i] * s2[c] + b2[c] (a projecting
// bottleneck's downsample), and act is ReLU or the identity.
//
// Replaces no TPU kernel.  On the TPU, XLA fuses the BatchNorm, the residual
// add and the ReLU into the convolutions' output; in PyTorch each is an ATen
// pass of its own (a multiply, an add, a ReLU, a residual add, and two more
// passes for a downsample's BatchNorm), each reading and writing the whole
// activation.  This kernel does those operations in one pass over the
// convolution's output.
//
// Exactness: every operation is the plain version's
// (face_crop_plus_tpu_torch/ops/nn.py: bn_act_plain), in its order, each
// rounded on its own: __fmul_rn, then __fadd_rn, then the residual's own
// multiply and add, then the add, then ReLU as ATen's clamp_min computes it
// (a NaN passes through, else fmaxf(v, 0)).  Built with -fmad=false besides,
// so nothing contracts into an FMA: the output equals the plain version's
// bit for bit.
//
// What bounds it on this card: bytes.  One multiply and one add an element
// against 8 bytes moved (12 with a residual, 12 with a downsample's input),
// far below the card's ~20 operations a byte.  Its design:
//   * the work is cut into units: a run of at most kSegment elements of one
//     (n, c) plane, whose H*W elements are contiguous.  A warp takes one
//     unit, so the channel, its scale and bias (and the residual's), and the
//     unit's offsets are worked out once and held in registers;
//   * the run's body moves as aligned 16-byte vectors, kUnroll of them in
//     flight per lane and per tensor before the first store; a head of up to
//     3 elements (until x is 16-byte aligned) and a tail of up to 3 go one
//     element a lane.  The launcher takes the vector path when every base
//     pointer is 16-byte aligned and the output's batch stride keeps it in
//     step with x; otherwise every element goes one a lane;
//   * the output may be x itself (each element is read before the same
//     thread writes it) or a channel slice of a larger NCHW tensor, given by
//     its pointer and batch stride: the detector's SSH writes its three
//     branches into one concatenated output this way;
//   * the residual kind and the ReLU are template parameters (12
//     instantiations with the vector switch), so no element branches on
//     them; offsets are 64-bit, computed once a unit.
//
// Measured by chip_smoke.py phase 2c on an H100 80GB HBM3 (700 W), the 69
// epilogues of one 16 x 1024^2 detector forward from a cold L2: 12.1 ms
// against 10.6 ms by bytes (35.5 GB), 87 % of the bound (80-90 % on the
// large tensors; 43-74 % on the smallest, of 4-34 MB, where a launch is a
// few microseconds); the ATen passes it replaces take 44.1 ms, and the
// forward falls from 193 to 161 ms with the same output bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Elements of one plane a warp walks (a multiple of 4): 32 float4 a lane.
constexpr long long kSegment = 4096;
constexpr int kUnroll = 4;

enum Residual { kNone = 0, kPlain = 1, kAffine = 2 };

struct Args {
  const float* x;
  const float* scale;
  const float* bias;
  const float* res;        // kPlain, kAffine
  const float* res_scale;  // kAffine
  const float* res_bias;   // kAffine
  float* out;
  int c;
  long long hw;
  long long out_gap;  // out's batch stride less c * hw, in elements
  long long units_per_plane;
  long long units;
};

template <int RES, bool RELU>
__device__ __forceinline__ float epilogue(float x, float s, float b, float r, float s2,
                                          float b2) {
  float y = __fadd_rn(__fmul_rn(x, s), b);
  if (RES == kPlain) y = __fadd_rn(y, r);
  if (RES == kAffine) y = __fadd_rn(y, __fadd_rn(__fmul_rn(r, s2), b2));
  // ATen's clamp_min(v, 0): NaN propagates, else ::max(v, 0) = fmaxf.
  if (RELU) y = isnan(y) ? y : fmaxf(y, 0.0f);
  return y;
}

template <int RES, bool RELU>
__device__ __forceinline__ float4 epilogue4(float4 x, float s, float b, float4 r, float s2,
                                            float b2) {
  return make_float4(epilogue<RES, RELU>(x.x, s, b, r.x, s2, b2),
                     epilogue<RES, RELU>(x.y, s, b, r.y, s2, b2),
                     epilogue<RES, RELU>(x.z, s, b, r.z, s2, b2),
                     epilogue<RES, RELU>(x.w, s, b, r.w, s2, b2));
}

template <int RES, bool RELU, bool VEC>
__global__ void __launch_bounds__(kThreads) bn_act_kernel(Args a) {
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (unit >= a.units) return;
  const int lane = threadIdx.x & 31;
  const long long p = unit / a.units_per_plane;  // plane n * c + channel
  const long long begin = (unit - p * a.units_per_plane) * kSegment;
  const long long len = min(kSegment, a.hw - begin);
  const int ch = static_cast<int>(p % a.c);
  const long long off = p * a.hw + begin;
  const float s = a.scale[ch], b = a.bias[ch];
  float s2 = 0.0f, b2 = 0.0f;
  if (RES == kAffine) {
    s2 = a.res_scale[ch];
    b2 = a.res_bias[ch];
  }
  const float* x = a.x + off;
  const float* r = RES != kNone ? a.res + off : nullptr;
  float* o = a.out + off + (p / a.c) * a.out_gap;

  long long head = 0, body = 0;
  if (VEC) {
    head = min(static_cast<long long>((4 - (off & 3)) & 3), len);
    body = (len - head) >> 2;
  }
  // Scalar head (vector path) or the whole run (scalar path).
  const long long scalar_end = VEC ? head : len;
  for (long long j = lane; j < scalar_end; j += 32)
    o[j] = epilogue<RES, RELU>(x[j], s, b, RES != kNone ? r[j] : 0.0f, s2, b2);
  if (!VEC) return;

  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const float4* r4 = RES != kNone ? reinterpret_cast<const float4*>(r + head) : nullptr;
  float4* o4 = reinterpret_cast<float4*>(o + head);
  for (long long j = lane; j < body; j += 32 * kUnroll) {
    float4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long q = j + 32 * k;
      if (q < body) {
        xv[k] = x4[q];
        rv[k] = RES != kNone ? r4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long q = j + 32 * k;
      if (q < body) o4[q] = epilogue4<RES, RELU>(xv[k], s, b, rv[k], s2, b2);
    }
  }
  // Scalar tail.
  const long long tail = head + 4 * body;
  if (lane < len - tail) {
    const long long j = tail + lane;
    o[j] = epilogue<RES, RELU>(x[j], s, b, RES != kNone ? r[j] : 0.0f, s2, b2);
  }
}

template <int RES, bool RELU>
cudaError_t launch(const Args& a, bool vec, cudaStream_t s) {
  const long long blocks = (a.units + kWarps - 1) / kWarps;
  if (vec)
    bn_act_kernel<RES, RELU, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  else
    bn_act_kernel<RES, RELU, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches the epilogue on `stream` without synchronising.  x, res: n*c
// planes of hw contiguous floats; out: the same planes at batch stride
// out_batch_stride (c * hw when out is contiguous, or x itself).  residual:
// 0 none, 1 plain, 2 affine (res * res_scale[c] + res_bias[c]).  vec: every
// pointer is 16-byte aligned and (out_batch_stride - c * hw) % 4 == 0.
// The launch is made on `device`, the stream's card, which is made current
// for it and then restored.  Requires n, c, hw >= 1 and fewer than 2^31 * 8
// units.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int fcpt_bn_act(const float* x, const float* scale, const float* bias,
                           const float* res, const float* res_scale,
                           const float* res_bias, float* out, long long n, int c,
                           long long hw, long long out_batch_stride, int residual,
                           int relu, int vec, int device, void* stream) {
  Args a;
  a.x = x;
  a.scale = scale;
  a.bias = bias;
  a.res = res;
  a.res_scale = res_scale;
  a.res_bias = res_bias;
  a.out = out;
  a.c = c;
  a.hw = hw;
  a.out_gap = out_batch_stride - static_cast<long long>(c) * hw;
  a.units_per_plane = (hw + kSegment - 1) / kSegment;
  a.units = n * c * a.units_per_plane;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (residual == kNone)
    err = relu ? launch<kNone, true>(a, v, s) : launch<kNone, false>(a, v, s);
  else if (residual == kPlain)
    err = relu ? launch<kPlain, true>(a, v, s) : launch<kPlain, false>(a, v, s);
  else
    err = relu ? launch<kAffine, true>(a, v, s) : launch<kAffine, false>(a, v, s);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* fcpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
