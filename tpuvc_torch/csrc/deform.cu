// Modulated deformable convolution of an NHWC float32 map, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tpuvc/ops/deform_pallas.py::_deform_band_kernel
// (launched by _deform_pallas_planar under deform_sample_accum, dispatched by
// tpuvc/ops/deform.py::_deform_fused). What it computes is tpuvc's
// tap-unrolled formulation _deform_taps(force_xla=True) with the bias added
// at the end:
//
//   out[b,y,x,g*Og+o] = bias[g*Og+o] + sum_t sum_c w[g,t,c,o] * m[b,y,x,g,t]
//                       * bilinear_zero(x[b,:,:,g*Cg+c], y+ky-1+dy, x+kx-1+dx)
//
// for T = K*K taps t = ky*K + kx, offsets (dy, dx) per (group, tap) in
// torchvision's layout, and torchvision's zero padding: a bilinear corner
// outside the frame weighs 0.
//
// What bounds it: bytes. Its least traffic is x, offsets, masks and out read
// or written once (2.6 GB at the v4 codec's largest level); the float32
// arithmetic (~150 operations per pixel, group and tap) is ~2x below that
// at the card's 67 TFLOP/s.
//
// Design: the TPU kernel's band windows, planar layout, channel caps
// (MAX_CHANNELS=16, MAX_OUT=8), per-tile walk ranges and row-uniform fast
// paths exist for VMEM and lane gathers; none of that carries over. Here one
// thread computes one (b, y, x, g): per tap it computes the sample point and
// the four corner weights once, then walks the group's Cg input channels
// (contiguous in NHWC) and accumulates its Og outputs in registers, in
// chunks of OG_CHUNK, so any Og runs. The group is a grid axis, so a block
// stages its group's T*Cg*Og weights in shared memory (read from device
// memory where they would not fit). Taps are summed outer and channels
// inner, the order of the plain version (tpuvc_torch.ops.deform.deform_plain),
// every sum and product explicitly rounded, no atomics: the result is the
// same on every run, which the codec's encoder/decoder agreement needs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OG_CHUNK = 8;     // outputs held in registers per pass
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;

__global__ void __launch_bounds__(THREADS)
deform_conv_nhwc_kernel(const float* __restrict__ x,
                        const float* __restrict__ offsets,
                        const float* __restrict__ masks,
                        const float* __restrict__ weight,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int B, int H, int W, int G,
                        int Cg, int Og, int K, int smem) {
  extern __shared__ float w_s[];
  const int g = blockIdx.y;
  const int T = K * K;
  const int nw = T * Cg * Og;
  const float* w_g = weight + static_cast<int64_t>(g) * nw;
  if (smem) {
    for (int i = threadIdx.x; i < nw; i += blockDim.x) w_s[i] = __ldg(w_g + i);
    __syncthreads();
  }
  const float* wt = smem ? w_s : w_g;

  const int p = blockIdx.x * blockDim.x + threadIdx.x;  // pixel of (B, H, W)
  if (p >= B * H * W) return;
  const int xq = p % W;
  const int r = p / W;
  const int yq = r % H;
  const int b = r / H;
  const int C = G * Cg;
  const int pad = K / 2;
  const float* xb = x + static_cast<int64_t>(b) * H * W * C + g * Cg;
  const float* off = offsets + static_cast<int64_t>(p) * (G * T * 2) + g * T * 2;
  const float* msk = masks + static_cast<int64_t>(p) * (G * T) + g * T;
  float* dst = out + static_cast<int64_t>(p) * (G * Og) + g * Og;

  for (int o0 = 0; o0 < Og; o0 += OG_CHUNK) {
    const int on = min(OG_CHUNK, Og - o0);
    float acc[OG_CHUNK];
#pragma unroll
    for (int j = 0; j < OG_CHUNK; ++j) acc[j] = 0.0f;

    for (int t = 0; t < T; ++t) {
      const int ky = t / K;
      const int kx = t - ky * K;
      const float dy = __ldg(off + 2 * t);
      const float dx = __ldg(off + 2 * t + 1);
      const float m = __ldg(msk + t);
      // flow = offset + tap base, then the sample point, as the plain version
      float sx = __fadd_rn(static_cast<float>(xq),
                           __fadd_rn(dx, static_cast<float>(kx - pad)));
      float sy = __fadd_rn(static_cast<float>(yq),
                           __fadd_rn(dy, static_cast<float>(ky - pad)));
      // Points beyond a corner's reach of the frame sample only zeros; the
      // clamp keeps their integer corners in range and changes nothing else.
      sx = fminf(fmaxf(sx, -2.0f), static_cast<float>(W) + 1.0f);
      sy = fminf(fmaxf(sy, -2.0f), static_cast<float>(H) + 1.0f);
      const float x0 = floorf(sx);
      const float y0 = floorf(sy);
      const float fx = __fsub_rn(sx, x0);
      const float fy = __fsub_rn(sy, y0);
      const float gx = __fsub_rn(1.0f, fx);
      const float gy = __fsub_rn(1.0f, fy);
      const int x0i = static_cast<int>(x0);
      const int y0i = static_cast<int>(y0);
      const int x1i = x0i + 1;
      const int y1i = y0i + 1;
      const bool vx0 = x0i >= 0 && x0i <= W - 1;
      const bool vx1 = x1i >= 0 && x1i <= W - 1;
      const bool vy0 = y0i >= 0 && y0i <= H - 1;
      const bool vy1 = y1i >= 0 && y1i <= H - 1;
      const float w00 = (vy0 && vx0) ? __fmul_rn(gy, gx) : 0.0f;
      const float w01 = (vy0 && vx1) ? __fmul_rn(gy, fx) : 0.0f;
      const float w10 = (vy1 && vx0) ? __fmul_rn(fy, gx) : 0.0f;
      const float w11 = (vy1 && vx1) ? __fmul_rn(fy, fx) : 0.0f;
      const float* p00 = (vy0 && vx0) ? xb + (static_cast<int64_t>(y0i) * W + x0i) * C : nullptr;
      const float* p01 = (vy0 && vx1) ? xb + (static_cast<int64_t>(y0i) * W + x1i) * C : nullptr;
      const float* p10 = (vy1 && vx0) ? xb + (static_cast<int64_t>(y1i) * W + x0i) * C : nullptr;
      const float* p11 = (vy1 && vx1) ? xb + (static_cast<int64_t>(y1i) * W + x1i) * C : nullptr;

      float part[OG_CHUNK];
#pragma unroll
      for (int j = 0; j < OG_CHUNK; ++j) part[j] = 0.0f;
      const float* wtc = wt + t * Cg * Og + o0;
      for (int c = 0; c < Cg; ++c) {
        const float v00 = p00 ? __ldg(p00 + c) : 0.0f;
        const float v01 = p01 ? __ldg(p01 + c) : 0.0f;
        const float v10 = p10 ? __ldg(p10 + c) : 0.0f;
        const float v11 = p11 ? __ldg(p11 + c) : 0.0f;
        float s = __fmul_rn(v00, w00);
        s = __fadd_rn(s, __fmul_rn(v01, w01));
        s = __fadd_rn(s, __fmul_rn(v10, w10));
        s = __fadd_rn(s, __fmul_rn(v11, w11));
        s = __fmul_rn(s, m);
        const float* wc = wtc + c * Og;
#pragma unroll
        for (int j = 0; j < OG_CHUNK; ++j) {
          if (j < on) part[j] = __fadd_rn(part[j], __fmul_rn(s, wc[j]));
        }
      }
#pragma unroll
      for (int j = 0; j < OG_CHUNK; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
    }
#pragma unroll
    for (int j = 0; j < OG_CHUNK; ++j) {
      if (j < on) dst[o0 + j] = __fadd_rn(acc[j], __ldg(bias + g * Og + o0 + j));
    }
  }
}

}  // namespace

extern "C" {

// x (B,H,W,G*Cg), offsets (B,H,W,G*K*K*2), masks (B,H,W,G*K*K),
// weight (G,K*K,Cg,Og), bias (G*Og) and out (B,H,W,G*Og): contiguous float32
// on the current device. Launches on `stream` (a cudaStream_t) and returns
// the cudaGetLastError() code of the launch (0 on success).
int tpuvc_deform_conv_nhwc(const void* x, const void* offsets,
                           const void* masks, const void* weight,
                           const void* bias, void* out, int B, int H, int W,
                           int G, int Cg, int Og, int K, void* stream) {
  const int64_t pixels = static_cast<int64_t>(B) * H * W;
  if (pixels == 0 || G == 0 || Og == 0) return 0;
  const int64_t w_bytes = static_cast<int64_t>(K) * K * Cg * Og * sizeof(float);
  const int smem = w_bytes <= MAX_SMEM ? 1 : 0;
  const int smem_bytes = smem ? static_cast<int>(w_bytes) : 0;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        deform_conv_nhwc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((pixels + THREADS - 1) / THREADS),
                  static_cast<unsigned>(G));
  deform_conv_nhwc_kernel<<<grid, THREADS, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(offsets),
      static_cast<const float*>(masks), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, G,
      Cg, Og, K, smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
