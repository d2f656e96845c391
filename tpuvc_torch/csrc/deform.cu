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
// What bounds it. Its least device-memory traffic is x, offsets, masks and
// out read or written once (2.6 GB, 0.78 ms at the v4 codec's largest level,
// x (2,544,960,128), 16 groups of 8 channels); the float32 arithmetic is
// ~2x below that at the card's 67 TFLOP/s. But the corners are gathers: each
// (pixel, group, tap) reads 4 corners of Cg contiguous floats at places the
// offsets choose, 601 M 32-byte sectors through L1 at that level.
//
// The first design (one thread per (pixel, group), the group a grid axis)
// walked each pixel's Cg channels with scalar loads, so neighbouring lanes
// were C*4 bytes apart and every warp-wide load touched ~32 sectors to move
// 4 useful bytes a lane. It was bound by L1 wavefronts: on an H100 SXM at
// 700 W, 21.09 ms at that level (27x its byte bound), 7.748 ms at
// (2,272,480,192), 2.618 ms at (2,136,240,256), and slower as offsets
// spread (38.34 ms at +-40 px). This design takes 4.725, 1.888 and 0.678 ms
// there with smooth +-5 px offsets, 10.18 ms at +-40 px; its time still
// grows with offset spread, the mark of gather traffic through L1 and L2
// rather than of device-memory bytes.
//
// This design maps lanes to channels. A lane is one unit of V channels
// (V=4: a float4 of 4 contiguous channels of one group) of one pixel; a
// block is PX pixels of one image row times all C/V units, and walks tiles
// of PX pixels (a persistent grid, a few blocks an SM), so the weights of
// all groups are staged in shared memory once per block, laid out by lane
// so that a warp reads consecutive float4s (18 / 41 / 74 KB at the v4
// levels; read from device memory through L1 where they would not fit).
// Blocks take tiles in panels 128 pixels wide, top to bottom, so the tiles
// in flight cover a patch of the frame rather than a band of whole rows,
// and corners that offsets of tens of pixels send far stay in L2. Per tap:
//   gather   the lane computes its group's sample point and four corner
//            weights (duplicated over the Cg/V lanes of a group, which is
//            cheap), loads the four corners (a warp-wide load is 16 B a lane
//            on contiguous channels: whole sectors, 4x fewer instructions
//            than scalar walks), blends and modulates them, and stores its V
//            samples in a shared-memory row per pixel; the next tap's offsets
//            and mask are loaded meanwhile (register prefetch);
//   contract after one barrier, the lane sums its group's Cg samples against
//            the tap's weights for its share of the group's Og outputs (lane
//            k of the group: outputs k, k + Cg/V, ...), channels outer and
//            its outputs inner, so its sums run side by side in registers.
// The sample rows are double-buffered, so the gather of tap t+1 overwrites
// the buffer that tap t-1 read, and one barrier a tap suffices. A lane holds
// at most MAXO outputs; a group with more outputs than that per lane runs
// the taps again for each further share. Where Cg % 4 != 0 or x is not
// 16-byte aligned, the same kernel runs with V=1: a lane is one channel.
// Offsets are 32-bit: the wrapper keeps every tensor below 2^31 elements.
//
// Rows of the output: the kernel computes output rows [y0, y0 + H_out) of
// the deform conv of a map x of H rows (y0 = 0, H_out = H for the whole
// frame). offsets, masks and out hold just those rows; tap positions are
// y0 + y + ky - pad + dy, and the zero padding applies at the frame's
// border [0, H). A rank of an H-sharded forward
// (tpuvc_torch.parallel.spatial) computes its own rows of a gathered x this
// way. Each output pixel's arithmetic is the same as in the whole-frame
// launch, so its rows equal those of the whole frame bit for bit.
//
// No tensor cores. Per group the product is [pixels x 9*Cg] x [9*Cg x Og]
// with Og = 4-8, below wgmma's N and mma.sync's useful width; a dense
// block-diagonal product over all groups would do G x the work; TF32
// (~5e-4 relative) cannot meet the kernel's 2e-5 bar against deform_plain;
// and the float32 operation bound (0.34 ms at the largest level) is already
// below the byte bound.
//
// Arithmetic: float32 throughout, every sum and product explicitly rounded
// (the file is built with --fmad=false), taps summed outer, within a tap the
// channels in order, the bias last, no atomics: every launch gives the same
// bits, which the codec's encoder/decoder agreement needs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAXO = 8;                  // most outputs a lane holds in registers
constexpr int MAX_SMEM = 227 * 1024;
constexpr int WEIGHT_SMEM = 100 * 1024;  // stage weights up to this total
constexpr int PANEL = 128;               // pixels across a panel of tiles

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

// Row stride of the sample buffer, in floats: V=4 rows 4 banks apart, odd
// for V=1.
__host__ __device__ __forceinline__ int sample_stride(int C, int V) {
  return V == 4 ? C + 4 : (C | 1);
}

// Block (C/V lanes, PX pixels); grid: any number of blocks, each walking
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... A lane holds NO outputs
// (2 at the v4 levels, else MAXO). y is the output row, row0 + y the
// frame's.
template <int V, int NO>
__global__ void __launch_bounds__(MAX_THREADS, 2)
deform_conv_nhwc_kernel(const float* __restrict__ x,
                        const float* __restrict__ offsets,
                        const float* __restrict__ masks,
                        const float* __restrict__ weight,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int B, int H, int W, int G,
                        int Cg, int Og, int K, int row0, int H_out,
                        int smem_w) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int C = G * Cg;
  const int Co = G * Og;
  const int T = K * K;
  const int pad = K / 2;
  const int PX = blockDim.y;
  const int SP = sample_stride(C, V);
  float* const samples = smem;                 // 2 x PX x SP
  float* const w_s = samples + 2 * PX * SP;    // T x Cg x NO x U, if staged
  const int U = blockDim.x;                    // lanes of a pixel
  const int Ug = Cg / V;                       // lanes of a group

  // Staged weights are laid out by lane: w_s[(((t*Ug + cv)*NO + i)*U + u)*V
  // + r] is lane u's i-th output at channel cv*V + r of its group (zero past
  // Og), so a warp reads consecutive float4s.
  if (smem_w) {
    const int nw = T * Cg * NO * U;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int idx = tid; idx < nw; idx += blockDim.x * blockDim.y) {
      const int r = idx % V;
      int rest = idx / V;
      const int u = rest % U;
      rest /= U;
      const int tcv = rest / NO;  // t*Ug + cv
      const int gu = u / Ug;
      const int o = u - gu * Ug + (rest - tcv * NO) * Ug;
      w_s[idx] = o < Og ? __ldg(weight + (tcv * V + r) * Co + gu * Og + o) : 0.0f;
    }
    __syncthreads();
  }

  const int c0 = threadIdx.x * V;  // this lane's first channel
  const int g = c0 / Cg;
  const int k = (c0 - g * Cg) / V; // this lane's place in its group
  const int py = threadIdx.y;
  const int tiles_per_row = (W + PX - 1) / PX;
  const int tiles = B * H_out * tiles_per_row;
  const int PW = PANEL / PX > 1 ? PANEL / PX : 1;  // tiles a panel
  int q = 0;  // taps run so far: picks the sample buffer

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // Tiles run in panels PW tiles wide, top to bottom, so the tiles in
    // flight cover a patch of the frame, not a band of whole rows: with
    // offsets of tens of pixels their corners then stay in L2.
    const int b = tile / (H_out * tiles_per_row);
    const int rem = tile - b * H_out * tiles_per_row;
    const int panel = rem / (H_out * PW);
    const int pw = min(PW, tiles_per_row - panel * PW);
    const int in_panel = rem - panel * H_out * PW;
    const int y = in_panel / pw;
    const int row = b * H_out + y;
    const int xq = (panel * PW + in_panel - y * pw) * PX + py;
    const bool active = xq < W;
    const int pix = row * W + xq;
    const float* xb = x + b * H * W * C + c0;
    const float* off = offsets + pix * (G * T * 2) + g * T * 2;
    const float* msk = masks + pix * (G * T) + g * T;

    for (int o0 = 0; o0 < Og; o0 += Ug * NO) {
      float acc[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
      float dy = 0.0f, dx = 0.0f, m = 0.0f;
      if (active) {
        dy = __ldg(off);
        dx = __ldg(off + 1);
        m = __ldg(msk);
      }
      for (int t = 0; t < T; ++t, ++q) {
        float* const s = samples + (q & 1) * PX * SP + py * SP;
        if (active) {
          const int ky = t / K;
          const int kx = t - ky * K;
          // flow = offset + tap base, then the sample point, as the plain version
          float sx = __fadd_rn(static_cast<float>(xq),
                               __fadd_rn(dx, static_cast<float>(kx - pad)));
          float sy = __fadd_rn(static_cast<float>(row0 + y),
                               __fadd_rn(dy, static_cast<float>(ky - pad)));
          const float mt = m;
          // Points beyond a corner's reach of the frame sample only zeros; the
          // clamp keeps their integer corners in range and changes nothing else.
          sx = fminf(fmaxf(sx, -2.0f), static_cast<float>(W) + 1.0f);
          sy = fminf(fmaxf(sy, -2.0f), static_cast<float>(H) + 1.0f);
          const float fx0 = floorf(sx);
          const float fy0 = floorf(sy);
          const float fx = __fsub_rn(sx, fx0);
          const float fy = __fsub_rn(sy, fy0);
          const float gx = __fsub_rn(1.0f, fx);
          const float gy = __fsub_rn(1.0f, fy);
          const int x0i = static_cast<int>(fx0);
          const int y0i = static_cast<int>(fy0);
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
          float v00[V] = {}, v01[V] = {}, v10[V] = {}, v11[V] = {};
          if (vy0 && vx0) load<V>(xb + (y0i * W + x0i) * C, v00);
          if (vy0 && vx1) load<V>(xb + (y0i * W + x1i) * C, v01);
          if (vy1 && vx0) load<V>(xb + (y1i * W + x0i) * C, v10);
          if (vy1 && vx1) load<V>(xb + (y1i * W + x1i) * C, v11);
          if (t + 1 < T) {  // the next tap's offsets and mask, while these land
            dy = __ldg(off + 2 * (t + 1));
            dx = __ldg(off + 2 * (t + 1) + 1);
            m = __ldg(msk + t + 1);
          }
          float r[V];
#pragma unroll
          for (int i = 0; i < V; ++i) {
            float a = __fmul_rn(v00[i], w00);
            a = __fadd_rn(a, __fmul_rn(v01[i], w01));
            a = __fadd_rn(a, __fmul_rn(v10[i], w10));
            a = __fadd_rn(a, __fmul_rn(v11[i], w11));
            r[i] = __fmul_rn(a, mt);
          }
          if constexpr (V == 4) {
            *reinterpret_cast<float4*>(s + c0) = make_float4(r[0], r[1], r[2], r[3]);
          } else {
            s[c0] = r[0];
          }
        }
        // The tap's samples are complete. The buffer the next tap writes was
        // last read by the previous tap's contraction, which ended before here.
        __syncthreads();

        if (active) {
          // Channels outer, the lane's NO outputs inner: NO independent sums,
          // each over the group's channels in order.
          const float* sg = s + g * Cg;
          float part[NO];
#pragma unroll
          for (int i = 0; i < NO; ++i) part[i] = 0.0f;
          for (int cv = 0; cv < Ug; ++cv) {
            float sv[V];
            float wv[NO][V];
            if constexpr (V == 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(sg + 4 * cv);
              sv[0] = q4.x;
              sv[1] = q4.y;
              sv[2] = q4.z;
              sv[3] = q4.w;
            } else {
              sv[0] = sg[cv];
            }
            if (smem_w) {
              const float* wl = w_s + ((t * Ug + cv) * NO * U + threadIdx.x) * V;
#pragma unroll
              for (int i = 0; i < NO; ++i) {
                if constexpr (V == 4) {
                  const float4 q4 = *reinterpret_cast<const float4*>(wl + i * U * 4);
                  wv[i][0] = q4.x;
                  wv[i][1] = q4.y;
                  wv[i][2] = q4.z;
                  wv[i][3] = q4.w;
                } else {
                  wv[i][0] = wl[i * U];
                }
              }
            } else {
              const float* wg = weight + (t * Cg + cv * V) * Co + g * Og + o0 + k;
#pragma unroll
              for (int i = 0; i < NO; ++i) {
                const bool valid = o0 + k + i * Ug < Og;
#pragma unroll
                for (int r = 0; r < V; ++r) wv[i][r] = valid ? __ldg(wg + r * Co + i * Ug) : 0.0f;
              }
            }
#pragma unroll
            for (int i = 0; i < NO; ++i) {
#pragma unroll
              for (int r = 0; r < V; ++r) part[i] = __fadd_rn(part[i], __fmul_rn(sv[r], wv[i][r]));
            }
          }
#pragma unroll
          for (int i = 0; i < NO; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        }
      }
      if (active) {
        float* dst = out + pix * Co + g * Og + o0 + k;
        const float* bj = bias + g * Og + o0 + k;
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          if (o0 + k + i * Ug < Og) dst[i * Ug] = __fadd_rn(acc[i], __ldg(bj + i * Ug));
        }
      }
    }
  }
}

template <int V, int NO>
int launch(const float* x, const float* offsets, const float* masks,
           const float* weight, const float* bias, float* out, int B, int H,
           int W, int G, int Cg, int Og, int K, int row0, int H_out,
           cudaStream_t stream) {
  const int lanes = G * Cg / V;
  if (lanes > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const int PX = MAX_THREADS / lanes;
  const int64_t base = 2LL * PX * sample_stride(G * Cg, V) * sizeof(float);
  const int64_t w_bytes = static_cast<int64_t>(K) * K * Cg * NO * lanes * sizeof(float);
  if (base > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // Staged only where one pass covers the outputs (Og <= NO lanes' worth).
  const int smem_w = Og <= NO * (Cg / V) && base + w_bytes <= WEIGHT_SMEM ? 1 : 0;
  const int smem_bytes = static_cast<int>(base + (smem_w ? w_bytes : 0));
  cudaError_t e = cudaFuncSetAttribute(
      deform_conv_nhwc_kernel<V, NO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(lanes, PX);
  int per_sm = 0, device = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, deform_conv_nhwc_kernel<V, NO>, lanes * PX, smem_bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t tiles = static_cast<int64_t>(B) * H_out * ((W + PX - 1) / PX);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  deform_conv_nhwc_kernel<V, NO><<<grid, block, smem_bytes, stream>>>(
      x, offsets, masks, weight, bias, out, B, H, W, G, Cg, Og, K, row0, H_out,
      smem_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B,H,W,G*Cg), offsets (B,H_out,W,G*K*K*2), masks (B,H_out,W,G*K*K),
// weight (K*K,Cg,G*Og): per tap and input channel of a group, the group's
// outputs in output-channel order; bias (G*Og) and out (B,H_out,W,G*Og):
// contiguous float32 on the current device; out holds output rows
// [y0, y0 + H_out) of the frame's, 0 <= y0 <= y0 + H_out <= H. Launches on `stream` (a
// cudaStream_t) and returns the cudaGetLastError() code of the launch (0 on
// success; cudaErrorInvalidValue where G*Cg/V > 512 lanes, V = 4 for Cg % 4
// == 0 and x 16-byte aligned, else 1).
int tpuvc_deform_conv_nhwc(const void* x, const void* offsets,
                           const void* masks, const void* weight,
                           const void* bias, void* out, int B, int H, int W,
                           int G, int Cg, int Og, int K, int y0, int H_out,
                           void* stream) {
  if (y0 < 0 || H_out < 0 || y0 + H_out > H) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * H_out * W == 0 || G == 0 || Og == 0) return 0;
  const int V = Cg % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 4 : 1;
  const bool two = (Og + Cg / V - 1) / (Cg / V) <= 2;  // outputs per lane
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto run = [&](auto launcher) {
    return launcher(f(x), f(offsets), f(masks), f(weight), f(bias),
                    static_cast<float*>(out), B, H, W, G, Cg, Og, K, y0, H_out,
                    static_cast<cudaStream_t>(stream));
  };
  if (V == 4) return two ? run(launch<4, 2>) : run(launch<4, MAXO>);
  return two ? run(launch<1, 2>) : run(launch<1, MAXO>);
}

}  // extern "C"
