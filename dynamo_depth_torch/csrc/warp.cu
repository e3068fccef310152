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
// output); the backward likewise (grid and gradient in, d_grid out). The
// design therefore moves each byte once: one thread per output pixel reads
// its grid point once, does the unnormalize / border clamp / floor / clip in
// registers, reads the four taps of every channel (neighbouring threads read
// neighbouring taps, so the gathers mostly hit the same cache lines) and
// writes each channel's output once, coalesced across the warp. No packed
// tap tensor or intermediate coordinate tensor goes through device memory,
// which the TPU version needed for its tiling.
//
// The backward sums the coordinate gradient over channels in registers and
// writes d_grid once per pixel; it is zero where the clamp saturates (the
// coordinate lies outside [0, size-1]). d_image, needed only when the image
// requires a gradient, is the scatter-add transpose of the four taps, done
// with atomicAdd into a zeroed buffer, so its sums run in no fixed order.
//
// Layouts: image (B, C, H, W), grid (B, Ho, Wo, 2) as (x, y), out
// (B, C, Ho, Wo); all float32, contiguous. H, W >= 2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Coord {
  int i0;      // tap origin, in [0, size - 2]
  float w;     // lerp weight toward i0 + 1, in [0, 1]
  bool inside; // unclamped coordinate within [0, size - 1]
};

__device__ __forceinline__ Coord unnormalize(float g, int size) {
  const float hi = static_cast<float>(size - 1);
  const float u = (g + 1.0f) * 0.5f * hi;
  const float c = fminf(fmaxf(u, 0.0f), hi);
  const float f = fminf(fmaxf(floorf(c), 0.0f), static_cast<float>(size - 2));
  Coord r;
  r.i0 = static_cast<int>(f);
  r.w = c - f;
  r.inside = (u >= 0.0f) && (u <= hi);
  return r;
}

__global__ void warp_fwd_kernel(const float* __restrict__ img, const float* __restrict__ grid,
                                float* __restrict__ out, int B, int C, int H, int W, int Ho,
                                int Wo) {
  const long long P = static_cast<long long>(Ho) * Wo;
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= B * P) return;
  const int b = static_cast<int>(n / P);
  const long long p = n - b * P;

  const Coord cx = unnormalize(grid[2 * n], W);
  const Coord cy = unnormalize(grid[2 * n + 1], H);
  const long long HW = static_cast<long long>(H) * W;
  const float* src = img + b * C * HW + static_cast<long long>(cy.i0) * W + cx.i0;
  float* dst = out + b * C * P + p;
  for (int c = 0; c < C; ++c) {
    const float* s = src + c * HW;
    const float v00 = s[0], v01 = s[1], v10 = s[W], v11 = s[W + 1];
    const float top = v00 + (v01 - v00) * cx.w;
    const float bot = v10 + (v11 - v10) * cx.w;
    dst[c * P] = top + (bot - top) * cy.w;
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
  d_grid[2 * n] = cx.inside ? dwx * 0.5f * static_cast<float>(W - 1) : 0.0f;
  d_grid[2 * n + 1] = cy.inside ? dwy * 0.5f * static_cast<float>(H - 1) : 0.0f;
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int warp_fwd(const float* img, const float* grid, float* out, int B, int C, int H,
                        int W, int Ho, int Wo, void* stream) {
  const long long n = static_cast<long long>(B) * Ho * Wo;
  if (n > 0) {
    warp_fwd_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, grid, out, B, C, H, W, Ho, Wo);
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
