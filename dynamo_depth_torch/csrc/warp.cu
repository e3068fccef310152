// Bilinear warp: grid_sample(padding_mode='border', align_corners=True).
//
// Replaces the TPU kernel `_taps_kernel` (dynamo_depth_tpu/ops/pallas/
// warp_kernel.py, launched by `_pallas_taps`) together with the coordinate
// math and the lerp that the JAX package ran around it in XLA
// (`grid_sample_pallas`, same file, and ops/warp.py:25-41), forward (K1
// warp_fwd) and backward (K2 warp_bwd).
//
// Bound on the H100: bytes. Per output pixel and 3 channels the forward does
// ~15 flops against 32 bytes it must move (8 of grid, 12 of taps, 12 of
// output); the backward likewise (grid and gradient in, d_grid out).
//
// K1, designed for Hopper:
// - Tile: a block of 32x4 threads owns a 64x4 output tile, batch on
//   blockIdx.z; offsets within a plane are 32-bit, with no 64-bit division.
// - Per-thread work: 2 neighbouring output pixels of one row. Their grid
//   points come in one 16-byte load, and each channel's two outputs leave as
//   one 8-byte store (when Wo is even; scalar accesses otherwise and at the
//   ragged right edge). A warp reads 512 contiguous bytes of grid and writes
//   256 contiguous bytes per channel.
// - Taps: gathered straight from device memory through the read-only path.
//   On a grid of identity plus ego-motion and flow of a few to tens of
//   pixels a warp's 64 pixels read two rows of ~65 neighbouring floats per
//   channel, so the gathers hit L1 and L2 and the kernel runs near its
//   bytes bound. Staging each tile's source window in shared memory was
//   tried and measured slower on such a grid (PERF.md): the
//   block-wide bounding-box reduction and barrier cost more than the L1
//   hits they replace. On a uniform random grid every tap of every pixel
//   lands in its own 32-byte sector and the kernel is bound by that traffic.
//
// K2: one thread per output pixel reads its grid point once, does the
// unnormalize / border clamp / floor / clip in registers, reads the four
// taps of every channel, sums the coordinate gradient over channels in
// registers and writes d_grid once per pixel; it is zero where the clamp
// saturates (the coordinate lies outside [0, size-1]) and half where the
// coordinate lies exactly on 0 or size-1, as jnp.clip's. d_image, needed only
// when the image requires a gradient, is the scatter-add transpose of the
// four taps, done with atomicAdd into a zeroed buffer, so its sums run in no
// fixed order.
//
// Layouts: image (B, C, H, W), grid (B, Ho, Wo, 2) as (x, y), out
// (B, C, Ho, Wo); all float32, contiguous. H, W >= 2; H * W and Ho * Wo
// below 2^31.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // K2: one output pixel per thread

// K1 tiling.
constexpr int FWD_TX = 32, FWD_TY = 4;  // threads per block
constexpr int FWD_PX = 2;               // output pixels per thread, along a row
constexpr int FWD_TW = FWD_TX * FWD_PX; // output tile width (64); height FWD_TY

struct Coord {
  int i0;        // tap origin, in [0, size - 2]
  float w;       // lerp weight toward i0 + 1, in [0, 1]
  float inside;  // d clamp / d u: 1 strictly inside [0, size - 1], 0.5 on its
                 // bounds (jnp.clip's subgradient), 0 outside
};

__device__ __forceinline__ Coord unnormalize(float g, int size) {
  const float hi = static_cast<float>(size - 1);
  const float u = (g + 1.0f) * 0.5f * hi;
  const float c = fminf(fmaxf(u, 0.0f), hi);
  const float f = fminf(fmaxf(floorf(c), 0.0f), static_cast<float>(size - 2));
  Coord r;
  r.i0 = static_cast<int>(f);
  r.w = c - f;
  r.inside = (u > 0.0f && u < hi) ? 1.0f : ((u == 0.0f || u == hi) ? 0.5f : 0.0f);
  return r;
}

__global__ void __launch_bounds__(FWD_TX * FWD_TY)
    warp_fwd_kernel(const float* __restrict__ img, const float* __restrict__ grid,
                    float* __restrict__ out, int C, int H, int W, int Ho, int Wo, bool vec) {
  const int b = blockIdx.z;
  const int ox = blockIdx.x * FWD_TW + threadIdx.x * FWD_PX;
  const int oy = blockIdx.y * FWD_TY + threadIdx.y;
  if (oy >= Ho || ox >= Wo) return;
  const int n = min(FWD_PX, Wo - ox);  // this thread's pixels
  const int at = oy * Wo + ox;         // offset within an output plane
  const size_t HW = static_cast<size_t>(H) * W, P = static_cast<size_t>(Ho) * Wo;

  float g[2 * FWD_PX];
  const float* gp = grid + 2 * (b * P + at);
  if (vec && n == FWD_PX) {
    const float4 v = *reinterpret_cast<const float4*>(gp);
    g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 2 * FWD_PX; ++k) g[k] = k < 2 * n ? gp[k] : 0.f;
  }
  int off[FWD_PX];  // tap origin within an image plane
  float wx[FWD_PX], wy[FWD_PX];
#pragma unroll
  for (int k = 0; k < FWD_PX; ++k) {
    const Coord cx = unnormalize(g[2 * k], W), cy = unnormalize(g[2 * k + 1], H);
    off[k] = cy.i0 * W + cx.i0;
    wx[k] = cx.w;
    wy[k] = cy.w;
  }

  const float* src = img + b * C * HW;
  float* dst = out + b * C * P + at;
  for (int c = 0; c < C; ++c) {
    float v[FWD_PX];
#pragma unroll
    for (int k = 0; k < FWD_PX; ++k) {
      const float* s = src + c * HW + off[k];
      const float v00 = __ldg(s), v01 = __ldg(s + 1), v10 = __ldg(s + W), v11 = __ldg(s + W + 1);
      const float top = v00 + (v01 - v00) * wx[k];
      const float bot = v10 + (v11 - v10) * wx[k];
      v[k] = top + (bot - top) * wy[k];
    }
    float* d = dst + c * P;
    if (vec && n == FWD_PX) {
      *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int k = 0; k < FWD_PX; ++k)
        if (k < n) d[k] = v[k];
    }
  }
}

__global__ void warp_bwd_kernel(const float* __restrict__ img, const float* __restrict__ grid,
                                const float* __restrict__ g_out, float* __restrict__ d_grid,
                                float* __restrict__ d_img, int B, int C, int H, int W, int Ho,
                                int Wo) {
  const long long P = static_cast<long long>(Ho) * Wo;
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= B * P) return;
  const int b = static_cast<int>(n / P);
  const long long p = n - b * P;

  const Coord cx = unnormalize(grid[2 * n], W);
  const Coord cy = unnormalize(grid[2 * n + 1], H);
  const long long HW = static_cast<long long>(H) * W;
  const long long origin = static_cast<long long>(cy.i0) * W + cx.i0;
  const float* src = img + b * C * HW + origin;
  const float* go = g_out + b * C * P + p;
  float dwx = 0.0f, dwy = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float* s = src + c * HW;
    const float v00 = s[0], v01 = s[1], v10 = s[W], v11 = s[W + 1];
    const float g = go[c * P];
    const float top = v00 + (v01 - v00) * cx.w;
    const float bot = v10 + (v11 - v10) * cx.w;
    dwy += g * (bot - top);
    dwx += g * ((1.0f - cy.w) * (v01 - v00) + cy.w * (v11 - v10));
    if (d_img != nullptr) {
      float* d = d_img + (b * C + c) * HW + origin;
      const float gt = g * (1.0f - cy.w), gb = g * cy.w;
      atomicAdd(d, gt * (1.0f - cx.w));
      atomicAdd(d + 1, gt * cx.w);
      atomicAdd(d + W, gb * (1.0f - cx.w));
      atomicAdd(d + W + 1, gb * cx.w);
    }
  }
  d_grid[2 * n] = cx.inside * dwx * 0.5f * static_cast<float>(W - 1);
  d_grid[2 * n + 1] = cy.inside * dwy * 0.5f * static_cast<float>(H - 1);
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int warp_fwd(const float* img, const float* grid, float* out, int B, int C, int H,
                        int W, int Ho, int Wo, void* stream) {
  if (B > 0 && Ho > 0 && Wo > 0) {
    const bool vec = Wo % 2 == 0 && reinterpret_cast<uintptr_t>(grid) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
    const dim3 blocks((Wo + FWD_TW - 1) / FWD_TW, (Ho + FWD_TY - 1) / FWD_TY, B);
    warp_fwd_kernel<<<blocks, dim3(FWD_TX, FWD_TY), 0, static_cast<cudaStream_t>(stream)>>>(
        img, grid, out, C, H, W, Ho, Wo, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int warp_bwd(const float* img, const float* grid, const float* g_out, float* d_grid,
                        float* d_img, int B, int C, int H, int W, int Ho, int Wo, void* stream) {
  const long long n = static_cast<long long>(B) * Ho * Wo;
  if (n > 0) {
    warp_bwd_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, grid, g_out, d_grid, d_img, B, C, H, W, Ho, Wo);
  }
  return static_cast<int>(cudaGetLastError());
}
