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
// output).
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
// K2 replaces `_gather_taps_bwd` (warp_kernel.py:126), the backward of the
// tap gather, which gave d_image as XLA's scatter transpose, together with
// XLA's autodiff of the coordinate math and the lerp, which gave d_grid
// (warp_kernel.py:144-172, ops/warp.py:25-41). It fuses both: d_grid always,
// d_image only when the image needs a gradient (never on the main path,
// whose warped images are inputs).
//
// Bound on the H100: bytes. Per output pixel and 3 channels it moves 40
// bytes (8 of grid, 12 of taps, 12 of gradient in; 8 of d_grid out) against
// ~44 float32 operations.
//
// K2, designed for Hopper:
// - Tile: a block of 16x8 threads owns a 32x8 output tile, batch on
//   blockIdx.z; offsets within a plane are 32-bit, with no 64-bit division.
//   On the main path's grids this square tile reads a smaller source window
//   than K1's 64x4 one, and more of its taps hit L1.
// - Per-thread work: 2 neighbouring output pixels of one row: one 16-byte
//   load of their grid points, one 8-byte load of their gradient per
//   channel, one 16-byte store of their four d_grid values. Odd Wo, and a
//   grid, gradient or d_grid off that alignment, take an instance with
//   scalar accesses.
// - Loads before arithmetic: the C = 3 instance is unrolled, its source
//   asks for the 3 gradient loads, then the grid's, then all 24 taps of its
//   2 pixels, then the arithmetic. Held to 40 registers, ptxas issues the
//   grid load first and then the 24 tap and 3 gradient loads in groups
//   between the lerps (264 instructions: one LDG.E.128, three LDG.E.64, 24
//   LDG.E, one STG.E.128, no call). A generic instance takes the channel
//   count at run time and loads one channel at a time.
// - 40 registers a thread, with no spill (__launch_bounds__ asks for 12
//   blocks on an SM), so the main path's 1,440 blocks fit the 132 SMs in one
//   wave; left to itself the compiler took 56 (9 blocks on an SM, 1.2
//   waves), slower in the step. The d_image instances are left to the
//   compiler (71-92 registers): held to 40, they spilled.
// - d_image is a template parameter. The main path's instance has no
//   atomics; the other scatter-adds the transpose of the four taps into a
//   zeroed buffer with atomicAdd, so its sums run in no fixed order.
// - The coordinate gradient is zero where the clamp saturates (the coordinate
//   lies outside [0, size-1]) and half where it lies exactly on 0 or size-1,
//   as jnp.clip's.
// Measured and dropped (PERF.md): 64x4 tiles, 4 pixels a thread, a
// persistent grid-stride launch, 32 or 56 registers, the gradient loaded
// with the taps, one channel's loads at a time (closest to the old kernel on
// a uniform random grid, slower on the main path's), taps cached in L2 only,
// each tap row's pair from one 16-byte load, the most L1 by carve-out.
//
// bfloat16 operands (K1 warp_fwd_bf16, K2 warp_bwd_bf16): the JAX package
// casts the warp's source image to bfloat16 under --image_dtype bfloat16, and
// under auto from 7 * 2^17 pixels per device (training/losses.py:36-90);
// `_pallas_taps` then gathers bfloat16 taps (warp_kernel.py:83). These
// instances are the same templates with the image as __nv_bfloat16: each tap
// is read as bfloat16 and widened to float32, and every operation after that
// runs in float32, so an instance is exactly the float32 kernel applied to
// the bfloat16-rounded image. The grid, the gradient, the output and d_grid
// stay float32; d_image, where the image needs one, is summed into a zeroed
// float32 buffer that the wrapper casts to bfloat16.
// - Bound: bytes, with 6 of taps per pixel at C = 3 instead of 12: K1 moves
//   26 bytes per pixel (8 of grid, 6 of taps, 12 of output), K2 34 (8 of
//   grid, 6 of taps, 12 of gradient, 8 of d_grid).
// - Taps: 2-byte loads from the three channel planes through the read-only
//   path. A tap row's pair (v00, v01) comes in one 4-byte load where it is
//   4-byte aligned (an even origin, on an aligned plane), else as two 2-byte
//   loads; the float32 instances keep their four 4-byte loads.
// - Tiles and register budgets of their own (Tiles<__nv_bfloat16>), chosen
//   at B=8, 192x640 on the batch-8 step's warp inputs (PERF.md): K1 takes
//   K2's square tile (16x8 threads, a 32x8 output tile, whose source window
//   is smaller than the 64x4 tile's), 3% faster with a cold L2; K2 takes 56
//   registers a thread (9 blocks on an SM) in place of 40, 10% faster.
//   Vectors are the float32 instances'.
// - Measured and dropped (PERF.md): persistent blocks walking whole output
//   rows or 64-pixel column bands, their grid and gradient brought one to
//   three rows ahead by cp.async.bulk (TMA) into a ring of shared memory on
//   mbarriers, or by plain loads one row ahead; L2 prefetch of the source
//   rows, of the next wave's streams or of every input at the start; other
//   tiles and register budgets. The TMA ring shrank the L1 that the tap
//   gathers hit, and a walker's rows ran one after another: 15-235% slower
//   with a cold L2 than the float32 instances' tiles.
//
// Layouts: image (B, C, H, W), grid (B, Ho, Wo, 2) as (x, y), out and g_out
// (B, C, Ho, Wo), d_grid (B, Ho, Wo, 2); contiguous; the image float32 or
// bfloat16, the rest float32. H, W >= 2; H * W and Ho * Wo below 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// K1 tiling.
constexpr int FWD_TX = 32, FWD_TY = 4;  // threads per block
constexpr int FWD_PX = 2;               // output pixels per thread, along a row
constexpr int FWD_TW = FWD_TX * FWD_PX; // output tile width (64); height FWD_TY

// K2 tiling.
constexpr int BWD_TX = 16, BWD_TY = 8;   // threads per block
constexpr int BWD_PX = 2;                // output pixels per thread, along a row
constexpr int BWD_TW = BWD_TX * BWD_PX;  // output tile width (32); height BWD_TY
constexpr int BWD_BLOCKS_PER_SM = 12;    // holds a thread to 40 registers (without d_image)

// K1's threads per block (FX x FY) and the blocks on an SM that K2's
// launch bounds ask for without d_image, by image type: the bfloat16
// instances' K1 takes K2's tile, and their K2 9 blocks, which hold a thread
// to 56 registers.
template <typename T>
struct Tiles {
  static constexpr int FX = FWD_TX, FY = FWD_TY, BWD_MINB = BWD_BLOCKS_PER_SM;
};
template <>
struct Tiles<__nv_bfloat16> {
  static constexpr int FX = BWD_TX, FY = BWD_TY, BWD_MINB = 9;
};

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

// A tap row's pair s[0], s[1] of the image, as float32.
__device__ __forceinline__ void load_pair(const float* s, float& a, float& b) {
  a = __ldg(s);
  b = __ldg(s + 1);
}

__device__ __forceinline__ void load_pair(const __nv_bfloat16* s, float& a, float& b) {
  if ((reinterpret_cast<uintptr_t>(s) & 3) == 0) {
    const float2 v = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(s)));
    a = v.x;
    b = v.y;
  } else {
    a = __bfloat162float(__ldg(s));
    b = __bfloat162float(__ldg(s + 1));
  }
}

template <typename T>
__global__ void __launch_bounds__(Tiles<T>::FX * Tiles<T>::FY)
    warp_fwd_kernel(const T* __restrict__ img, const float* __restrict__ grid,
                    float* __restrict__ out, int C, int H, int W, int Ho, int Wo, bool vec) {
  const int b = blockIdx.z;
  const int ox = blockIdx.x * Tiles<T>::FX * FWD_PX + threadIdx.x * FWD_PX;
  const int oy = blockIdx.y * Tiles<T>::FY + threadIdx.y;
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

  const T* src = img + b * C * HW;
  float* dst = out + b * C * P + at;
  for (int c = 0; c < C; ++c) {
    float v[FWD_PX];
#pragma unroll
    for (int k = 0; k < FWD_PX; ++k) {
      const T* s = src + c * HW + off[k];
      float v00, v01, v10, v11;
      load_pair(s, v00, v01);
      load_pair(s + W, v10, v11);
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

// N consecutive floats through the read-only path, as float4s (N % 4 == 0)
// or one float2; p aligned to 4 * min(N, 4) bytes.
template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else {
    static_assert(N == 2, "load_vec takes 2 or a multiple of 4 floats");
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  }
}

template <typename T>
struct BwdArgs {
  const T* __restrict__ img;
  const float* __restrict__ grid;
  const float* __restrict__ g_out;
  float* __restrict__ d_grid;
  float* __restrict__ d_img;  // null unless the image needs a gradient
  int B, C, H, W, Ho, Wo;
};

// A thread's pixels: the first at offset `at` of an output plane, `n` of
// them inside the row; P and HW are the output and image plane sizes.
struct BwdPixels {
  size_t at, P, HW;
  int n;
};

// The gradient of N channels from plane0 at a thread's pixels.
template <int N, bool kVec, typename T>
__device__ __forceinline__ void load_grad(float (&go)[N][BWD_PX], const BwdArgs<T>& a, const BwdPixels& px,
                                          size_t plane0) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float* gs = a.g_out + (plane0 + i) * px.P + px.at;
    if constexpr (kVec) {
      load_vec(go[i], gs);
    } else {
#pragma unroll
      for (int k = 0; k < BWD_PX; ++k) go[i][k] = k < px.n ? __ldg(gs + k) : 0.f;
    }
  }
}

// N channels from plane0 of a thread's pixels, with their gradient go: every
// tap load first, then the arithmetic, so that the loads share their trips
// to memory. Adds into the pixels' coordinate gradients dwx, dwy.
template <int N, bool kImageGrad, typename T>
__device__ __forceinline__ void warp_bwd_channels(const BwdArgs<T>& a, const BwdPixels& px, size_t plane0,
                                                  const float (&go)[N][BWD_PX], const int (&off)[BWD_PX],
                                                  const Coord (&cx)[BWD_PX], const Coord (&cy)[BWD_PX],
                                                  float (&dwx)[BWD_PX], float (&dwy)[BWD_PX]) {
  float v[N][BWD_PX][4];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < BWD_PX; ++k) {
      const T* s = a.img + (plane0 + i) * px.HW + off[k];
      load_pair(s, v[i][k][0], v[i][k][1]);
      load_pair(s + a.W, v[i][k][2], v[i][k][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < BWD_PX; ++k) {
      const float v00 = v[i][k][0], v01 = v[i][k][1], v10 = v[i][k][2], v11 = v[i][k][3];
      const float wx = cx[k].w, wy = cy[k].w, g = go[i][k];
      const float top = v00 + (v01 - v00) * wx;
      const float bot = v10 + (v11 - v10) * wx;
      dwy[k] += g * (bot - top);
      dwx[k] += g * ((1.0f - wy) * (v01 - v00) + wy * (v11 - v10));
      if constexpr (kImageGrad) {
        if (k < px.n) {
          float* d = a.d_img + (plane0 + i) * px.HW + off[k];
          const float gt = g * (1.0f - wy), gb = g * wy;
          atomicAdd(d, gt * (1.0f - wx));
          atomicAdd(d + 1, gt * wx);
          atomicAdd(d + a.W, gb * (1.0f - wx));
          atomicAdd(d + a.W + 1, gb * wx);
        }
      }
    }
  }
}

// kC: the channel count, or 0 for one given at run time. kVec: the grid,
// gradient and d_grid are aligned for the vector accesses and Wo is even, so
// a thread's pixels are both inside the row.
template <typename T, int kC, bool kImageGrad, bool kVec>
__global__ void __launch_bounds__(BWD_TX * BWD_TY, kImageGrad ? 1 : Tiles<T>::BWD_MINB)
    warp_bwd_kernel(BwdArgs<T> a) {
  const int b = blockIdx.z;
  const int ox = blockIdx.x * BWD_TW + threadIdx.x * BWD_PX;
  const int oy = blockIdx.y * BWD_TY + threadIdx.y;
  if (oy >= a.Ho || ox >= a.Wo) return;
  const int nc = kC > 0 ? kC : a.C;
  BwdPixels px;
  px.n = kVec ? BWD_PX : min(BWD_PX, a.Wo - ox);
  px.at = oy * a.Wo + ox;
  px.P = static_cast<size_t>(a.Ho) * a.Wo;
  px.HW = static_cast<size_t>(a.H) * a.W;
  const size_t plane0 = static_cast<size_t>(b) * nc;  // the first channel's plane

  // The gradient does not depend on the grid: its loads go first.
  float go[kC > 0 ? kC : 1][BWD_PX];
  if constexpr (kC > 0) load_grad<kC, kVec>(go, a, px, plane0);
  float g[2 * BWD_PX];
  const float* gp = a.grid + 2 * (b * px.P + px.at);
  if constexpr (kVec) {
    load_vec(g, gp);
  } else {
#pragma unroll
    for (int k = 0; k < 2 * BWD_PX; ++k) g[k] = k < 2 * px.n ? __ldg(gp + k) : 0.f;
  }
  int off[BWD_PX];  // tap origin within an image plane
  Coord cx[BWD_PX], cy[BWD_PX];
#pragma unroll
  for (int k = 0; k < BWD_PX; ++k) {
    cx[k] = unnormalize(g[2 * k], a.W);
    cy[k] = unnormalize(g[2 * k + 1], a.H);
    off[k] = cy[k].i0 * a.W + cx[k].i0;
  }

  float dwx[BWD_PX], dwy[BWD_PX];
#pragma unroll
  for (int k = 0; k < BWD_PX; ++k) dwx[k] = dwy[k] = 0.0f;
  if constexpr (kC > 0) {
    warp_bwd_channels<kC, kImageGrad>(a, px, plane0, go, off, cx, cy, dwx, dwy);
  } else {
    for (int c = 0; c < nc; ++c) {
      load_grad<1, kVec>(go, a, px, plane0 + c);
      warp_bwd_channels<1, kImageGrad>(a, px, plane0 + c, go, off, cx, cy, dwx, dwy);
    }
  }

  const float sx = 0.5f * static_cast<float>(a.W - 1), sy = 0.5f * static_cast<float>(a.H - 1);
  float dg[2 * BWD_PX];
#pragma unroll
  for (int k = 0; k < BWD_PX; ++k) {
    dg[2 * k] = cx[k].inside * dwx[k] * sx;
    dg[2 * k + 1] = cy[k].inside * dwy[k] * sy;
  }
  float* dp = a.d_grid + 2 * (b * px.P + px.at);
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(dp) = make_float4(dg[0], dg[1], dg[2], dg[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 2 * BWD_PX; ++k)
      if (k < 2 * px.n) dp[k] = dg[k];
  }
}

template <typename T, int kC>
void launch_bwd(const BwdArgs<T>& a, cudaStream_t stream) {
  const dim3 blocks((a.Wo + BWD_TW - 1) / BWD_TW, (a.Ho + BWD_TY - 1) / BWD_TY, a.B);
  const dim3 threads(BWD_TX, BWD_TY);
  const bool vec = a.Wo % BWD_PX == 0 && reinterpret_cast<uintptr_t>(a.grid) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.d_grid) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.g_out) % (4 * BWD_PX) == 0;
  if (a.d_img != nullptr) {
    if (vec) warp_bwd_kernel<T, kC, true, true><<<blocks, threads, 0, stream>>>(a);
    else warp_bwd_kernel<T, kC, true, false><<<blocks, threads, 0, stream>>>(a);
  } else {
    if (vec) warp_bwd_kernel<T, kC, false, true><<<blocks, threads, 0, stream>>>(a);
    else warp_bwd_kernel<T, kC, false, false><<<blocks, threads, 0, stream>>>(a);
  }
}

template <typename T>
int warp_fwd_impl(const T* img, const float* grid, float* out, int B, int C, int H, int W, int Ho, int Wo,
                  void* stream) {
  if (B > 0 && Ho > 0 && Wo > 0) {
    const bool vec = Wo % 2 == 0 && reinterpret_cast<uintptr_t>(grid) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
    constexpr int TW = Tiles<T>::FX * FWD_PX, TY = Tiles<T>::FY;
    const dim3 blocks((Wo + TW - 1) / TW, (Ho + TY - 1) / TY, B);
    warp_fwd_kernel<T><<<blocks, dim3(Tiles<T>::FX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
        img, grid, out, C, H, W, Ho, Wo, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int warp_bwd_impl(const T* img, const float* grid, const float* g_out, float* d_grid, float* d_img, int B, int C,
                  int H, int W, int Ho, int Wo, void* stream) {
  if (B > 0 && Ho > 0 && Wo > 0) {
    const BwdArgs<T> a{img, grid, g_out, d_grid, d_img, B, C, H, W, Ho, Wo};
    const auto s = static_cast<cudaStream_t>(stream);
    if (C == 3) launch_bwd<T, 3>(a, s);
    else launch_bwd<T, 0>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int warp_fwd(const float* img, const float* grid, float* out, int B, int C, int H,
                        int W, int Ho, int Wo, void* stream) {
  return warp_fwd_impl(img, grid, out, B, C, H, W, Ho, Wo, stream);
}

extern "C" int warp_bwd(const float* img, const float* grid, const float* g_out, float* d_grid,
                        float* d_img, int B, int C, int H, int W, int Ho, int Wo, void* stream) {
  return warp_bwd_impl(img, grid, g_out, d_grid, d_img, B, C, H, W, Ho, Wo, stream);
}

// The bfloat16-image instances; d_img (null unless the image needs a
// gradient) is a zeroed float32 buffer of the image's shape.
extern "C" int warp_fwd_bf16(const __nv_bfloat16* img, const float* grid, float* out, int B, int C, int H,
                             int W, int Ho, int Wo, void* stream) {
  return warp_fwd_impl(img, grid, out, B, C, H, W, Ho, Wo, stream);
}

extern "C" int warp_bwd_bf16(const __nv_bfloat16* img, const float* grid, const float* g_out, float* d_grid,
                             float* d_img, int B, int C, int H, int W, int Ho, int Wo, void* stream) {
  return warp_bwd_impl(img, grid, g_out, d_grid, d_img, B, C, H, W, Ho, Wo, stream);
}
