// Bilinear backward warp of an NHWC float32 frame, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpuvc/ops/warp_pallas.py::_warp_band_kernel
// (launched by _warp_pallas_nhwc). What it computes is tpuvc's XLA
// formulation _warp_xla (warp_pallas.py:457-489):
//
//   x = clip(col + dx*sx, 0, W-1), y = clip(row + dy*sy, 0, H-1)
//   out[b,y,x,c] = (1-fy)(1-fx) img[y0,x0,c] + (1-fy)fx img[y0,x1,c]
//                + fy(1-fx) img[y1,x0,c] + fy fx img[y1,x1,c]
//
// with border clamping, or — when `zero` is set — the `flexrate` compat
// mode, tpuvc's zero-padding formulation: the flow shifted by -0.5, then the
// same warp over the frame surrounded by a one-pixel ring of zeros
// (coordinates in the ringed frame, taps on the ring read 0).
//
// What bounds it: bytes. The least traffic is img + flow read once and out
// written once (0.1596 ms at (8,1088,1920,3) at 3.35 TB/s); the ~20 float
// operations per output element are far below the card's float32 rate.
//
// The first design (one thread per output element, pixel x channel, over a
// flat grid-stride loop) was bound by instruction throughput, not bytes:
// every element redid six integer divisions by runtime C, W and H, re-read
// both flow values and redid the whole coordinate and weight computation,
// 3x per pixel at C=3 and 64x at C=64. It took 0.4860 ms at (8,1088,1920,3)
// and 0.6357 ms at (2,544,960,64) on an H100 SXM at 700 W, 1.25x and 1.40x
// slower than one F.grid_sample call. This design takes 0.3450 and 0.2323.
//
// This design: a 3D launch, x over W, y over H, z over B, so no thread
// divides by a runtime size, and 32-bit offsets (the wrapper keeps every
// tensor below 2^31 elements; 64-bit address arithmetic was measurably
// slower at C=3).
// A block is (lanes, pixels of a row, rows): each pixel's sample point,
// corners and four weights are computed from one float2 flow load by the
// lanes of that pixel, and the lanes then split its channels. Where C % 4 ==
// 0 (and the frames are 16-byte aligned) C/4 lanes each take a float4 of
// every corner and store a float4, once per pixel and channel quad;
// otherwise C lanes each take one channel. At C=3 that is 3 lanes a pixel,
// each with the pixel's coordinate work, over a square 8x8 tile of pixels:
// on the card one lane walking a pixel's 3 channels was slower (its lanes
// were 12 B apart, so each warp-wide load and store touched ~3x the
// sectors), and so was a row of pixels, whose corners overlap less in L1.
// Either way a warp's loads cover contiguous channels and consecutive
// threads store consecutive addresses. No shared memory, no atomics: every
// output element is written once by one thread.
//
// Rows of the output: the kernel writes output rows [y0, y0 + H_out) of the
// warp of a reference of H rows (H_out = H, y0 = 0 for the whole frame). The
// flow and the output hold just those rows; the sample coordinates, the
// border clamp and the lhbdc H/(H-1) scale are the reference's. A rank of an
// H-sharded forward (tpuvc_torch.parallel.spatial) warps its own rows of a
// gathered reference this way. Each output pixel's arithmetic is the same
// as in the whole-frame launch, so its rows equal those of the whole frame
// bit for bit.
//
// Every coordinate, weight and sum is computed with explicitly rounded
// intrinsics in the plain version's order (tpuvc_torch.ops.warp.warp_plain),
// and the file is built with --fmad=false, so no multiply-add is contracted
// and the kernel matches the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SQUARE = 8;        // pixels a side of a square tile
constexpr int SQUARE_LANES = 4;  // at most this many lanes a pixel

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Block (lanes, pixels of a row, rows); grid (ceil(W / pixels),
// ceil(H_out / rows), B). V channels per load. y is the output row, row0 + y
// the reference's.
template <int V>
__global__ void __launch_bounds__(THREADS)
warp_bilinear_nhwc_kernel(const float* __restrict__ img,
                          const float* __restrict__ flow,
                          float* __restrict__ out, int H, int W, int C,
                          float sx, float sy, int zero, int flow2, int row0,
                          int H_out) {
  const int x = blockIdx.x * blockDim.y + threadIdx.y;
  const int y = blockIdx.y * blockDim.z + threadIdx.z;
  if (x >= W || y >= H_out) return;
  const int b = blockIdx.z;
  const int off = zero ? 1 : 0;  // ring offset
  const int Hs = H + 2 * off;    // sampled frame size
  const int Ws = W + 2 * off;
  const int p = (b * H_out + y) * W + x;  // the wrapper keeps B*H*W*max(C, 2) < 2^31
  float dx, dy;
  if (flow2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(flow) + p);
    dx = f.x;
    dy = f.y;
  } else {
    dx = __ldg(flow + 2 * p);
    dy = __ldg(flow + 2 * p + 1);
  }
  if (zero) {  // flexrate's half-pixel shift, as the plain version's flow - 0.5
    dx = __fsub_rn(dx, 0.5f);
    dy = __fsub_rn(dy, 0.5f);
  }

  float xs = __fadd_rn(static_cast<float>(x + off), __fmul_rn(dx, sx));
  float ys = __fadd_rn(static_cast<float>(row0 + y + off), __fmul_rn(dy, sy));
  xs = fminf(fmaxf(xs, 0.0f), static_cast<float>(Ws - 1));
  ys = fminf(fmaxf(ys, 0.0f), static_cast<float>(Hs - 1));
  const float x0 = floorf(xs);
  const float y0 = floorf(ys);
  const float fx = __fsub_rn(xs, x0);
  const float fy = __fsub_rn(ys, y0);
  int x0i = static_cast<int>(x0);
  int y0i = static_cast<int>(y0);
  int x1i = min(x0i + 1, Ws - 1);
  int y1i = min(y0i + 1, Hs - 1);

  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const float w00 = __fmul_rn(gy, gx);
  const float w01 = __fmul_rn(gy, fx);
  const float w10 = __fmul_rn(fy, gx);
  const float w11 = __fmul_rn(fy, fx);

  // Ring coordinates back to frame coordinates; a tap on the ring reads 0.
  x0i -= off;
  x1i -= off;
  y0i -= off;
  y1i -= off;
  const bool vx0 = x0i >= 0 && x0i < W, vx1 = x1i >= 0 && x1i < W;
  const bool vy0 = y0i >= 0 && y0i < H, vy1 = y1i >= 0 && y1i < H;
  const float* base = img + b * H * W * C;
  const float* p00 = (vy0 && vx0) ? base + (y0i * W + x0i) * C : nullptr;
  const float* p01 = (vy0 && vx1) ? base + (y0i * W + x1i) * C : nullptr;
  const float* p10 = (vy1 && vx0) ? base + (y1i * W + x0i) * C : nullptr;
  const float* p11 = (vy1 && vx1) ? base + (y1i * W + x1i) * C : nullptr;
  float* dst = out + p * C;

  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float v00[V] = {}, v01[V] = {}, v10[V] = {}, v11[V] = {};
    if (p00) load<V>(p00 + c, v00);
    if (p01) load<V>(p01 + c, v01);
    if (p10) load<V>(p10 + c, v10);
    if (p11) load<V>(p11 + c, v11);
    float r[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float acc = __fmul_rn(w00, v00[k]);
      acc = __fadd_rn(acc, __fmul_rn(w01, v01[k]));
      acc = __fadd_rn(acc, __fmul_rn(w10, v10[k]));
      r[k] = __fadd_rn(acc, __fmul_rn(w11, v11[k]));
    }
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(dst + c) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
      dst[c] = r[0];
    }
  }
}

}  // namespace

extern "C" {

// img (B,H,W,C), flow (B,H_out,W,2) and out (B,H_out,W,C): contiguous
// float32 on the current device, B and H at most 65535, output rows
// [y0, y0 + H_out) within [0, H). Launches on `stream` (a cudaStream_t) and
// returns the cudaGetLastError() code of the launch (0 on success).
int tpuvc_warp_bilinear_nhwc(const void* img, const void* flow, void* out,
                             int B, int H, int W, int C, float sx, float sy,
                             int zero, int y0, int H_out, void* stream) {
  if (y0 < 0 || H_out < 0 || y0 + H_out > H) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * H_out * W * C == 0) return 0;
  if (B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int flow2 = reinterpret_cast<uintptr_t>(flow) % 8 == 0 ? 1 : 0;
  const int units = vec ? C / 4 : C;
  const int lanes = units < THREADS ? units : THREADS;
  // A few lanes a pixel: a square tile of pixels, whose corners overlap in
  // L1 more than a row's do. Else one row of THREADS / lanes pixels.
  const bool square = lanes <= SQUARE_LANES;
  const int pixels = square ? SQUARE : THREADS / lanes;
  const int rows = square ? SQUARE : 1;
  const dim3 block(lanes, pixels, rows);
  const dim3 grid((W + pixels - 1) / pixels, (H_out + rows - 1) / rows, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(img);
  const float* f = static_cast<const float*>(flow);
  float* o = static_cast<float*>(out);
  if (vec) {
    warp_bilinear_nhwc_kernel<4><<<grid, block, 0, s>>>(i, f, o, H, W, C, sx, sy, zero, flow2,
                                                     y0, H_out);
  } else {
    warp_bilinear_nhwc_kernel<1><<<grid, block, 0, s>>>(i, f, o, H, W, C, sx, sy, zero, flow2,
                                                     y0, H_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
