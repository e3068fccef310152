// Fused SSIM + L1 photometric error, forward (K3 photometric_fwd) and a
// hand-written backward (K4 photometric_bwd).
//
// Replaces the TPU kernel `_kernel` with `_mean3x3_roll` (dynamo_depth_tpu/
// ops/pallas/photometric_kernel.py, launched by `_pallas_forward`) together
// with the channel mean and the 0.85 SSIM + 0.15 L1 blend that ran outside
// it. The TPU kernel left its backward to XLA (`_bwd` there); K4 is the
// port's own. Semantics are those of ops/photometric.py:28-56: per (b, c)
// plane, s = clip((1 - SSIM) / 2, 0, 1) with 3x3 means over a reflect-padded
// window, C1 = 0.01^2, C2 = 0.03^2; out = w * mean_c(s) + (1 - w) * mean_c|t - p|.
//
// Bound on the H100: bytes. The forward must read pred and target once and
// write one float per pixel (28 B per pixel at C = 3) against ~40 flops per
// channel; the backward reads pred, target and the output gradient and
// writes d_pred (40 B per pixel). Design: a block owns a 32x8 output tile
// and, one channel at a time, stages the tile plus its reflect-indexed halo
// in shared memory, so each input byte comes from device memory about once
// (the halo adds 2/8 + 2/32 of re-reads). The five 3x3 moments, SSIM, the
// channel mean and the blend stay in registers; nothing but the (B, 1, H, W)
// result is written. The backward recomputes the moments of a tile grown by
// one pixel (halo of two for the inputs), turns them into four coefficient
// maps dL/d(mu_x, mu_y, E[x^2] = E[y^2] weight, E[xy]) in shared memory, zero
// where the clip saturates, and applies the transposed 3x3 stencil. The
// reflection sends the window of row 0 to row 1 twice and the window of row
// H-1 to row H-2 twice (likewise for columns), so the stencil weight of a
// neighbour is the number of its window taps that reflect onto the pixel.
//
// Layouts: pred, target (B, C, H, W); out and its gradient (B, 1, H, W);
// float32, contiguous; H, W >= 2.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr float kC1 = 0.01f * 0.01f;
constexpr float kC2 = 0.03f * 0.03f;

// jnp.pad(mode="reflect") index map: -1 -> 1, n -> n - 2. Indices further out
// only feed pixels outside the image and are clamped to stay in bounds.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

// How many taps of the 3-window centred on q (in range) reflect onto r.
__device__ __forceinline__ int taps_onto(int r, int q, int n) {
  if (q < 0 || q >= n) return 0;
  return (reflect(q - 1, n) == r) + (q == r) + (reflect(q + 1, n) == r);
}

struct Moments {
  float mx, my, exx, eyy, exy;
};

// 3x3 window moments of the tile entry whose window starts at (r, c).
template <int LD>
__device__ __forceinline__ Moments window(const float (*sx)[LD], const float (*sy)[LD], int r,
                                          int c) {
  Moments m = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float a = sx[r + i][c + j], b = sy[r + i][c + j];
      m.mx += a;
      m.my += b;
      m.exx += a * a;
      m.eyy += b * b;
      m.exy += a * b;
    }
  }
  m.mx /= 9.f;
  m.my /= 9.f;
  m.exx /= 9.f;
  m.eyy /= 9.f;
  m.exy /= 9.f;
  return m;
}

__global__ void photometric_fwd_kernel(const float* __restrict__ pred,
                                       const float* __restrict__ target, float* __restrict__ out,
                                       int C, int H, int W, float ssim_weight) {
  __shared__ float sx[TY + 2][TX + 2];
  __shared__ float sy[TY + 2][TX + 2];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int ox = x0 + tx, oy = y0 + ty;
  const bool valid = ox < W && oy < H;
  const long long HW = static_cast<long long>(H) * W;

  float ssim_sum = 0.f, l1_sum = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* px = pred + (static_cast<long long>(b) * C + c) * HW;
    const float* py = target + (static_cast<long long>(b) * C + c) * HW;
    for (int i = tid; i < (TY + 2) * (TX + 2); i += TX * TY) {
      const int r = i / (TX + 2), q = i % (TX + 2);
      const long long at = static_cast<long long>(reflect(y0 - 1 + r, H)) * W + reflect(x0 - 1 + q, W);
      sx[r][q] = px[at];
      sy[r][q] = py[at];
    }
    __syncthreads();
    if (valid) {
      const Moments m = window<TX + 2>(sx, sy, ty, tx);
      const float sigx = m.exx - m.mx * m.mx;
      const float sigy = m.eyy - m.my * m.my;
      const float sxy = m.exy - m.mx * m.my;
      const float num = (2.f * m.mx * m.my + kC1) * (2.f * sxy + kC2);
      const float den = (m.mx * m.mx + m.my * m.my + kC1) * (sigx + sigy + kC2);
      ssim_sum += fminf(fmaxf((1.f - num / den) / 2.f, 0.f), 1.f);
      l1_sum += fabsf(sy[ty + 1][tx + 1] - sx[ty + 1][tx + 1]);
    }
    __syncthreads();
  }
  if (valid) {
    out[b * HW + static_cast<long long>(oy) * W + ox] =
        ssim_weight * (ssim_sum / C) + (1.f - ssim_weight) * (l1_sum / C);
  }
}

__global__ void photometric_bwd_kernel(const float* __restrict__ pred,
                                       const float* __restrict__ target,
                                       const float* __restrict__ g_out,
                                       float* __restrict__ d_pred, float* __restrict__ d_target,
                                       int C, int H, int W, float ssim_weight) {
  // Inputs over the output tile grown by 2; coefficients over it grown by 1.
  __shared__ float sx[TY + 4][TX + 4];
  __shared__ float sy[TY + 4][TX + 4];
  __shared__ float sg[TY + 2][TX + 2];
  __shared__ float cP[TY + 2][TX + 2];  // dL/d mu_x / 9
  __shared__ float cQ[TY + 2][TX + 2];  // dL/d mu_y / 9
  __shared__ float cR[TY + 2][TX + 2];  // dL/d E[x^2] / 9 (= dL/d E[y^2] / 9)
  __shared__ float cS[TY + 2][TX + 2];  // dL/d E[xy] / 9
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int ox = x0 + tx, oy = y0 + ty;
  const bool valid = ox < W && oy < H;
  const long long HW = static_cast<long long>(H) * W;
  const float* g = g_out + b * HW;
  const float ssim_scale = ssim_weight / C;
  const float l1_scale = (1.f - ssim_weight) / C;

  for (int i = tid; i < (TY + 2) * (TX + 2); i += TX * TY) {
    const int r = i / (TX + 2), q = i % (TX + 2);
    const int qy = y0 - 1 + r, qx = x0 - 1 + q;
    sg[r][q] = (qy >= 0 && qy < H && qx >= 0 && qx < W) ? g[static_cast<long long>(qy) * W + qx] : 0.f;
  }

  // Stencil weights of this pixel's 3x3 neighbours (rows, then columns).
  int wr[3], wc[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    wr[d] = taps_onto(oy, oy - 1 + d, H);
    wc[d] = taps_onto(ox, ox - 1 + d, W);
  }

  for (int c = 0; c < C; ++c) {
    const long long plane = (static_cast<long long>(b) * C + c) * HW;
    const float* px = pred + plane;
    const float* py = target + plane;
    for (int i = tid; i < (TY + 4) * (TX + 4); i += TX * TY) {
      const int r = i / (TX + 4), q = i % (TX + 4);
      const long long at = static_cast<long long>(reflect(y0 - 2 + r, H)) * W + reflect(x0 - 2 + q, W);
      sx[r][q] = px[at];
      sy[r][q] = py[at];
    }
    __syncthreads();

    for (int i = tid; i < (TY + 2) * (TX + 2); i += TX * TY) {
      const int r = i / (TX + 2), q = i % (TX + 2);
      const int qy = y0 - 1 + r, qx = x0 - 1 + q;
      float P = 0.f, Q = 0.f, R = 0.f, S = 0.f;
      if (qy >= 0 && qy < H && qx >= 0 && qx < W) {
        const Moments m = window<TX + 4>(sx, sy, r, q);
        const float sigx = m.exx - m.mx * m.mx;
        const float sigy = m.eyy - m.my * m.my;
        const float sxy = m.exy - m.mx * m.my;
        const float A1 = 2.f * m.mx * m.my + kC1, B1 = 2.f * sxy + kC2;
        const float A2 = m.mx * m.mx + m.my * m.my + kC1, B2 = sigx + sigy + kC2;
        const float num = A1 * B1, den = A2 * B2;
        const float s = (1.f - num / den) / 2.f;
        // Zero gradient where the clip to [0, 1] saturates.
        const float a = (s >= 0.f && s <= 1.f) ? sg[r][q] * ssim_scale : 0.f;
        const float kN = -a / (2.f * den);              // dL/d num
        const float kD = a * num / (2.f * den * den);   // dL/d den
        P = (kN * 2.f * m.my * (B1 - A1) + kD * 2.f * m.mx * (B2 - A2)) / 9.f;
        Q = (kN * 2.f * m.mx * (B1 - A1) + kD * 2.f * m.my * (B2 - A2)) / 9.f;
        R = kD * A2 / 9.f;
        S = kN * 2.f * A1 / 9.f;
      }
      cP[r][q] = P;
      cQ[r][q] = Q;
      cR[r][q] = R;
      cS[r][q] = S;
    }
    __syncthreads();

    if (valid) {
      float sP = 0.f, sQ = 0.f, sR = 0.f, sS = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float k = static_cast<float>(wr[i] * wc[j]);
          sP += k * cP[ty + i][tx + j];
          sQ += k * cQ[ty + i][tx + j];
          sR += k * cR[ty + i][tx + j];
          sS += k * cS[ty + i][tx + j];
        }
      }
      const float xr = sx[ty + 2][tx + 2], yr = sy[ty + 2][tx + 2];
      const float diff = xr - yr;
      const float l1 = sg[ty + 1][tx + 1] * l1_scale *
                       (diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f));
      const long long at = plane + static_cast<long long>(oy) * W + ox;
      d_pred[at] = sP + 2.f * xr * sR + yr * sS + l1;
      if (d_target != nullptr) d_target[at] = sQ + 2.f * yr * sR + xr * sS - l1;
    }
    __syncthreads();
  }
}

dim3 tiles(int B, int H, int W) { return dim3((W + TX - 1) / TX, (H + TY - 1) / TY, B); }

}  // namespace

extern "C" int photometric_fwd(const float* pred, const float* target, float* out, int B, int C,
                               int H, int W, float ssim_weight, void* stream) {
  if (B > 0 && H > 0 && W > 0) {
    photometric_fwd_kernel<<<tiles(B, H, W), dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
        pred, target, out, C, H, W, ssim_weight);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int photometric_bwd(const float* pred, const float* target, const float* g_out,
                               float* d_pred, float* d_target, int B, int C, int H, int W,
                               float ssim_weight, void* stream) {
  if (B > 0 && H > 0 && W > 0) {
    photometric_bwd_kernel<<<tiles(B, H, W), dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
        pred, target, g_out, d_pred, d_target, C, H, W, ssim_weight);
  }
  return static_cast<int>(cudaGetLastError());
}
