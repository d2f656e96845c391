// The pass after a conv, for NVIDIA Hopper (sm_90a): the cuDNN conv's
// output read once in bfloat16 or float32, written once in float32, with
// its bias, a residual and its activation applied on the way:
//
//   out[i] = act(float(y[i]) + bias[c(i)] + res[i])
//
// act none, relu or leaky relu; bias and res each optional.
//
// Replaces no TPU kernel. On the TPU, XLA fused a conv's output cast, its
// bias add and the activation after it into the conv's own epilogue
// (tpuvc/models/layers.py's Conv inside one jitted program). PyTorch runs
// them eagerly, each as a full pass over the output: the cast (a copy
// kernel), the bias add, then relu (one kernel) or flax's leaky relu (three:
// ge, mul, where), and a residual add. For a bf16 output element that is
// 6 + 8 + 8 bytes (relu) or 6 + 8 + 26 (leaky) of traffic; this pass moves
// 6 (2 read, 4 written), 4 more where it adds a residual.
//
// What bounds it: bytes. A handful of float operations an element is far
// below the card's rate. So the design is about moving the bytes at the
// card's rate: each thread takes 8 consecutive elements at a time, one
// 16-byte load of bfloat16 (two of float32, two of the residual) and two
// 16-byte stores, over a grid-stride loop of a few blocks an SM. The bias
// comes through the read-only cache into registers: where channels are
// innermost and C % 8 == 0 the 8 elements share a pixel and their 8 biases
// are two 16-byte loads; otherwise the channel is followed element by
// element from one division a vector. Elements past the last whole vector,
// and every element of a launch whose pointers are not 16-byte aligned, go
// one at a time.
//
// Layout: y is the conv's output in whatever dense order cuDNN wrote it
// (channels-last, or NCHW for some small-channel outputs), and out is laid
// out in the same order, so the pass walks memory: element i's channel is
// (i / cstride) % C, cstride being the channel dimension's stride (1 for
// channels-last). res is laid out as out.
//
// Bits: the plain version's ops in its order, each rounded once
// (__fadd_rn, __fmul_rn; the file is built with --fmad=false): the cast by
// __bfloat162float, as ATen's bf16 -> f32 copy; then + bias, then + res;
// relu as ATen's clamp_min (NaN kept, else fmaxf(v, 0)); leaky relu as
// torch.where(x >= 0, x, slope * x), slope rounded to float32 as ATen
// rounds a Python scalar. So the output equals the plain version's bit for
// bit, NaN, infinities, -0.0 and subnormals included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;             // elements a thread takes at a time
constexpr int BLOCKS_PER_SM = 16;  // the grid-stride loop's grid: at most this many a SM

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == ACT_RELU) return isnan(v) ? v : fmaxf(v, 0.0f);
  if (act == ACT_LEAKY) return v >= 0.0f ? v : __fmul_rn(v, slope);
  return v;
}

template <bool BF16>
__device__ __forceinline__ float load1(const void* y, uint64_t i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(y)[i]);
  } else {
    return __ldg(static_cast<const float*>(y) + i);
  }
}

template <bool BF16>
__device__ __forceinline__ void load8(const void* y, uint64_t i, float (&v)[VEC]) {
  if constexpr (BF16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(y) + i));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __bfloat162float(h[k]);
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(y) + i);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ void add8(const float* p, float (&v)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = __fadd_rn(v[0], a.x); v[1] = __fadd_rn(v[1], a.y);
  v[2] = __fadd_rn(v[2], a.z); v[3] = __fadd_rn(v[3], a.w);
  v[4] = __fadd_rn(v[4], b.x); v[5] = __fadd_rn(v[5], b.y);
  v[6] = __fadd_rn(v[6], b.z); v[7] = __fadd_rn(v[7], b.w);
}

// I: the index type, 32-bit where n < 2^31. nvec: whole vectors to take 8 at
// a time (0 where the pointers are not aligned); bias8: the vectors' biases
// are two aligned float4 loads (channels innermost, C % 8 == 0).
template <bool BF16, typename I>
__global__ void __launch_bounds__(THREADS)
tpuvc_epilogue_pass(const void* __restrict__ y, const float* __restrict__ bias,
                    const float* __restrict__ res, float* __restrict__ out, I n,
                    I nvec, I C, I cstride, int act, float slope, int bias8) {
  const I stride = static_cast<I>(gridDim.x) * THREADS;
  const I t = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x;
  for (I v = t; v < nvec; v += stride) {
    const I i = v * VEC;
    float x[VEC];
    load8<BF16>(y, i, x);
    if (bias != nullptr) {
      if (bias8) {
        add8(bias + i % C, x);
      } else {
        const I q = i / cstride;
        I j = i - q * cstride;  // position inside the channel's run
        I c = q % C;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          x[k] = __fadd_rn(x[k], __ldg(bias + c));
          if (++j == cstride) {
            j = 0;
            if (++c == C) c = 0;
          }
        }
      }
    }
    if (res != nullptr) add8(res + i, x);
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = activate(x[k], act, slope);
    float4* o = reinterpret_cast<float4*>(out + i);
    o[0] = make_float4(x[0], x[1], x[2], x[3]);
    o[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
  for (I i = nvec * VEC + t; i < n; i += stride) {
    float x = load1<BF16>(y, i);
    if (bias != nullptr) x = __fadd_rn(x, __ldg(bias + (i / cstride) % C));
    if (res != nullptr) x = __fadd_rn(x, __ldg(res + i));
    out[i] = activate(x, act, slope);
  }
}

template <bool BF16, typename I>
void launch(const void* y, const float* bias, const float* res, float* out, int64_t n,
            int64_t nvec, int64_t C, int64_t cstride, int act, float slope, int bias8,
            int blocks, cudaStream_t s) {
  tpuvc_epilogue_pass<BF16, I><<<blocks, THREADS, 0, s>>>(
      y, bias, res, out, static_cast<I>(n), static_cast<I>(nvec), static_cast<I>(C),
      static_cast<I>(cstride), act, slope, bias8);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// y: n elements, bfloat16 (y_bf16 = 1) or float32, in a dense order whose
// channel dimension (C channels) has stride cstride; out: n float32 in the
// same order; bias: C float32 or null; res: n float32 in out's order or
// null; act 0 (none), 1 (relu) or 2 (leaky relu with `slope`); sms: the
// card's SM count. Launches on `stream` (a cudaStream_t), allocates
// nothing, and returns the cudaGetLastError() code of the launch (0 on
// success).
int tpuvc_epilogue(const void* y, int y_bf16, const void* bias, const void* res, void* out,
                   int64_t n, int64_t C, int64_t cstride, int act, float slope, int sms,
                   void* stream) {
  if (n < 0 || C < 1 || cstride < 1 || act < ACT_NONE || act > ACT_LEAKY || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const bool vec = aligned(y) && aligned(out) && (res == nullptr || aligned(res));
  const int64_t nvec = vec ? n / VEC : 0;
  const int bias8 = cstride == 1 && C % VEC == 0 && bias != nullptr && aligned(bias) ? 1 : 0;
  const int64_t work = (nvec > 0 ? nvec : n) + THREADS - 1;
  const int64_t cap = static_cast<int64_t>(sms) * BLOCKS_PER_SM;
  const int blocks = static_cast<int>(work / THREADS < cap ? work / THREADS : cap);
  const float* b = static_cast<const float*>(bias);
  const float* r = static_cast<const float*>(res);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = n + static_cast<int64_t>(sms) * BLOCKS_PER_SM * THREADS < (int64_t(1) << 31);
  if (y_bf16 && small) {
    launch<true, uint32_t>(y, b, r, o, n, nvec, C, cstride, act, slope, bias8, blocks, s);
  } else if (y_bf16) {
    launch<true, uint64_t>(y, b, r, o, n, nvec, C, cstride, act, slope, bias8, blocks, s);
  } else if (small) {
    launch<false, uint32_t>(y, b, r, o, n, nvec, C, cstride, act, slope, bias8, blocks, s);
  } else {
    launch<false, uint64_t>(y, b, r, o, n, nvec, C, cstride, act, slope, bias8, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
