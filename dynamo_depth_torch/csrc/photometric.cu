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
// Both are bound by bytes on the H100. The forward must read pred and target
// once and write one float per pixel (28 B per pixel at C = 3) against ~40
// flops per channel; the backward reads pred, target and the output gradient
// and writes d_pred (40 B per pixel) against ~150 flops per channel.
//
// K3, designed for Hopper: streaming column strips, no shared memory, no
// barrier.
// - Work: a warp owns a band of 30 output columns and a strip of FWD_ROWS = 8
//   output rows of one image. Lane l holds one column; lanes 1-30 produce
//   outputs, lanes 0 and 31 only load the band's left and right halo
//   columns. Each lane's column is reflected once (only at the image's left
//   and right edges does it move), the strip's 10 input rows once (only rows
//   -1 and H move); the rest is 32-bit indexing within a plane. A warp's
//   loads of one row are 32 consecutive floats.
// - Loads in flight: all 10 input rows of one channel of pred and target are
//   loaded into registers at once, and the next channel's rows are issued
//   before the current channel's math: 20 loads per lane, two channels in
//   flight together. The main path's 1,584 warps (127 registers a thread)
//   fit in one wave, so other warps' loads cover each warp's math.
// - Chosen over 2 or 4 columns per lane (vector loads) and 4- or 16-row
//   strips by measurement: those need more registers a lane (up to 255,
//   spilling at 4 columns) and give fewer warps, and ran slower.
// - Window sums: the horizontal 3-sums of x, y, x^2, y^2, xy of one input row
//   take the neighbour columns from the lanes beside (warp shuffles); those
//   of the two rows above stay in registers, so each window costs one add per
//   moment for the vertical sum instead of nine taps. 1/9 is a constant; one
//   division per pixel and channel.
// - Output: the channel mean and the blend accumulate in registers; one
//   coalesced float per pixel is written after the last channel.
//
// K4, designed for Hopper:
// - Tile: a 256-thread block owns a 64x16 output tile. Its inputs cover the
//   tile grown by 2 (20 rows x 68 columns, 1.33x the tile), its coefficient
//   maps the tile grown by 1 (18 x 66).
// - Staging: every channel of pred and target for the block goes to dynamic
//   shared memory at once, behind one barrier, as 16-byte `cp.async` copies
//   (rows of 72 floats starting 4 columns left of the tile, so each copy is
//   aligned). Out-of-image rows map to their reflected row at no cost; only
//   the 16-byte chunks that cross the left or right border (or every chunk,
//   when W is not a multiple of 4) are loaded one reflect-indexed float at a
//   time. Staging all channels (59,040 B at C = 3 with the coefficient maps,
//   3 blocks per SM) was chosen over double-buffering one channel: it needs
//   one barrier for the loads instead of one per channel, and 360 blocks of
//   the main path's 192x640x3 still fit in one wave on 132 SMs.
// - Coefficients: per channel, 198 threads (66 columns x 3 strips of 6 rows,
//   one round with 58 threads idle) each slide down a column strip: the
//   horizontal 3-sums of the five moment products of one input row, added to
//   those of the two rows above kept in registers, give each window's
//   moments (8 input rows read for 6 windows, instead of 9 taps per window).
//   Each entry turns them into four coefficient maps dL/d(mu_x, mu_y,
//   E[x^2] = E[y^2] weight, E[xy]), zero where the clip saturates, with one
//   reciprocal of `den`; the clip tests s = (1 - num * (1/den)) / 2. Its
//   edges cannot be observed: s = 0 needs equal windows, where the SSIM
//   gradient vanishes, and s = 1 needs SSIM = -1, which C1, C2 > 0 keep out
//   of reach. So s may differ from the plain version's num/den by an ulp.
// - Transposed stencil: the weight of a neighbour is wr[i] * wc[j], the
//   number of its window taps that reflect onto the pixel per axis (rows 1
//   and H-2, columns 1 and W-2 receive the reflected windows twice). Each of
//   the 256 threads owns a column strip of 4 outputs: a column pass with wc
//   over 6 coefficient rows, then a row pass with wr per output. d_pred (and
//   d_target when asked) is written once per pixel and channel, coalesced.
// - Barriers: one after the staging, then two per channel (coefficients
//   ready; coefficients consumed before the next channel overwrites them).
//
// Layouts: pred, target (B, C, H, W); out and its gradient (B, 1, H, W);
// float32, contiguous; H, W >= 2; H * W < 2^31. K4 takes C <= 18 (its staged
// channels must fit the card's shared memory per block).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kC1 = 0.01f * 0.01f;
constexpr float kC2 = 0.03f * 0.03f;
constexpr float k9 = 1.f / 9.f;

// K3 tiling.
constexpr int FWD_ROWS = 8;           // output rows per strip
constexpr int FWD_IN = FWD_ROWS + 2;  // input rows per strip
constexpr int FWD_SPAN = 30;          // output columns per warp (lanes 1-30)
constexpr int FWD_WARPS = 4;          // warps per block, on consecutive strips

// K4 tiling.
constexpr int BX = 64;                                 // output tile width
constexpr int BY = 16;                                 // output tile height
constexpr int STRIP = 4;                               // outputs per thread, vertical
constexpr int kBwdThreads = BX * BY / STRIP;           // 256
constexpr int IN_ROWS = BY + 4;                        // staged input rows
constexpr int IN_LD = BX + 8;                          // staged columns x0-4 .. x0+BX+3
constexpr int IN_CHUNKS = IN_LD / 4;                   // 16-byte chunks per staged row
constexpr int CO_ROWS = BY + 2;                        // coefficient rows
constexpr int CO_COLS = BX + 2;                        // coefficient columns
constexpr int CO_LD = BX + 4;
constexpr int CO_STRIP = 6;                            // coefficient rows per thread
constexpr int CO_THREADS = CO_COLS * (CO_ROWS / CO_STRIP);  // 198
constexpr int CO_MAP = CO_ROWS * CO_LD;
static_assert(CO_ROWS % CO_STRIP == 0, "coefficient strips must tile the rows");
static_assert(CO_THREADS <= kBwdThreads, "one round of coefficient strips");

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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Horizontal 3-sums of x, y, x^2, y^2, xy over three neighbouring columns.
__device__ __forceinline__ void row_sums(const float* x, const float* y, float h[5]) {
  const float a0 = x[0], a1 = x[1], a2 = x[2];
  const float b0 = y[0], b1 = y[1], b2 = y[2];
  h[0] = a0 + a1 + a2;
  h[1] = b0 + b1 + b2;
  h[2] = a0 * a0 + a1 * a1 + a2 * a2;
  h[3] = b0 * b0 + b1 * b1 + b2 * b2;
  h[4] = a0 * b0 + a1 * b1 + a2 * b2;
}

// ---- K3 --------------------------------------------------------------------

// One channel of a lane's strip: its column of the FWD_IN input rows.
struct Strip {
  float x[FWD_IN];  // pred
  float y[FWD_IN];  // target
};

__device__ __forceinline__ void load_strip(Strip& s, const float* __restrict__ px,
                                           const float* __restrict__ py, const int (&roff)[FWD_IN],
                                           int col) {
#pragma unroll
  for (int i = 0; i < FWD_IN; ++i) {
    s.x[i] = __ldg(px + roff[i] + col);
    s.y[i] = __ldg(py + roff[i] + col);
  }
}

// Adds one channel's ws * SSIM distance + wl * |t - p| to each output of the
// strip. The neighbour columns come from the lanes beside; lanes 0 and 31
// compute what no one keeps.
__device__ __forceinline__ void accumulate(const Strip& s, float (&acc)[FWD_ROWS], float ws,
                                           float wl) {
  constexpr unsigned kAll = 0xffffffffu;
  float up2[5] = {}, up1[5] = {};  // horizontal sums of the two rows above
#pragma unroll
  for (int i = 0; i < FWD_IN; ++i) {
    // The four shuffles of a row go out before any of them is used: written
    // as two initializer lists (shuffle, use, shuffle), the kernel measured
    // 14% slower.
    float a[3], b[3];
    a[0] = __shfl_up_sync(kAll, s.x[i], 1);
    b[0] = __shfl_up_sync(kAll, s.y[i], 1);
    a[2] = __shfl_down_sync(kAll, s.x[i], 1);
    b[2] = __shfl_down_sync(kAll, s.y[i], 1);
    a[1] = s.x[i];
    b[1] = s.y[i];
    float h[5];
    row_sums(a, b, h);
    if (i >= 2) {
      const float mx = (up2[0] + up1[0] + h[0]) * k9;
      const float my = (up2[1] + up1[1] + h[1]) * k9;
      const float exx = (up2[2] + up1[2] + h[2]) * k9;
      const float eyy = (up2[3] + up1[3] + h[3]) * k9;
      const float exy = (up2[4] + up1[4] + h[4]) * k9;
      const float sigx = exx - mx * mx;
      const float sigy = eyy - my * my;
      const float sxy = exy - mx * my;
      const float num = (2.f * mx * my + kC1) * (2.f * sxy + kC2);
      const float den = (mx * mx + my * my + kC1) * (sigx + sigy + kC2);
      const float ssim = fminf(fmaxf((1.f - __fdividef(num, den)) * 0.5f, 0.f), 1.f);
      acc[i - 2] += ws * ssim + wl * fabsf(s.y[i - 1] - s.x[i - 1]);
    }
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      up2[m] = up1[m];
      up1[m] = h[m];
    }
  }
}

__global__ void __launch_bounds__(32 * FWD_WARPS)
    photometric_fwd_kernel(const float* __restrict__ pred, const float* __restrict__ target,
                           float* __restrict__ out, int C, int H, int W, float ssim_weight) {
  const int row0 = (blockIdx.y * FWD_WARPS + threadIdx.y) * FWD_ROWS;
  if (row0 >= H) return;  // the whole warp
  const int lane = threadIdx.x, b = blockIdx.z;
  // Lane l holds column ox; lane 0's lies left of the band, lane 31's right.
  const int ox = blockIdx.x * FWD_SPAN + lane - 1;
  const int col = reflect(ox, W);
  int roff[FWD_IN];
#pragma unroll
  for (int i = 0; i < FWD_IN; ++i) roff[i] = reflect(row0 - 1 + i, H) * W;
  const size_t HW = static_cast<size_t>(H) * W;
  const float* px = pred + static_cast<size_t>(b) * C * HW;
  const float* py = target + static_cast<size_t>(b) * C * HW;

  const float ws = ssim_weight / C, wl = (1.f - ssim_weight) / C;
  float acc[FWD_ROWS] = {};
  Strip cur, nxt;
  load_strip(cur, px, py, roff, col);
  for (int c = 0; c < C; ++c) {
    // The next channel's loads go out before this channel's math.
    if (c + 1 < C) load_strip(nxt, px + (c + 1) * HW, py + (c + 1) * HW, roff, col);
    accumulate(cur, acc, ws, wl);
    if (c + 1 < C) cur = nxt;
  }
  if (lane < 1 || lane > 30 || ox >= W) return;
  float* o = out + b * HW + ox;
#pragma unroll
  for (int r = 0; r < FWD_ROWS; ++r)
    if (row0 + r < H) o[(row0 + r) * W] = acc[r];
}

// ---- K4 --------------------------------------------------------------------

__global__ void __launch_bounds__(kBwdThreads)
    photometric_bwd_kernel(const float* __restrict__ pred, const float* __restrict__ target,
                           const float* __restrict__ g_out, float* __restrict__ d_pred,
                           float* __restrict__ d_target, int C, int H, int W, float ssim_weight,
                           bool vec) {
  // [2C][IN_ROWS][IN_LD] inputs (pred channels, then target channels),
  // [CO_ROWS][CO_LD] output gradient, [4][CO_ROWS][CO_LD] coefficients
  // (dL/d mu_x / 9, dL/d mu_y / 9, dL/d E[x^2] / 9, dL/d E[xy] / 9).
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;
  float* s_g = s_in + 2 * C * IN_ROWS * IN_LD;
  float* s_co = s_g + CO_MAP;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int tid = threadIdx.x;
  const size_t HW = static_cast<size_t>(H) * W;
  const bool want_target = d_target != nullptr;

  // ---- stage every channel of pred and target, and the output gradient ----
  for (int k = tid; k < 2 * C * IN_ROWS * IN_CHUNKS; k += kBwdThreads) {
    const int chunk = k % IN_CHUNKS, row = (k / IN_CHUNKS) % IN_ROWS;
    const int plane = k / (IN_CHUNKS * IN_ROWS);
    const float* src = plane < C ? pred + (static_cast<size_t>(b) * C + plane) * HW
                                 : target + (static_cast<size_t>(b) * C + plane - C) * HW;
    src += reflect(y0 - 2 + row, H) * W;
    float* dst = s_in + (plane * IN_ROWS + row) * IN_LD + 4 * chunk;
    const int gx = x0 - 4 + 4 * chunk;
    if (vec && gx >= 0 && gx + 4 <= W) {
      cp_async16(dst, src + gx);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = src[reflect(gx + e, W)];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const float* g = g_out + b * HW;
  for (int i = tid; i < CO_ROWS * CO_COLS; i += kBwdThreads) {
    const int r = i / CO_COLS, q = i % CO_COLS;
    const int qy = y0 - 1 + r, qx = x0 - 1 + q;
    s_g[r * CO_LD + q] = (qy >= 0 && qy < H && qx >= 0 && qx < W) ? g[qy * W + qx] : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const float ssim_scale = ssim_weight / C;
  const float l1_scale = (1.f - ssim_weight) / C;

  // Output strip of this thread and its stencil weights (rows, then columns).
  const int lx = tid % BX, ly0 = (tid / BX) * STRIP;
  const int ox = x0 + lx;
  float wc[3], wr[STRIP][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) wc[j] = static_cast<float>(taps_onto(ox, ox - 1 + j, W));
#pragma unroll
  for (int t = 0; t < STRIP; ++t) {
    const int oy = y0 + ly0 + t;
#pragma unroll
    for (int i = 0; i < 3; ++i) wr[t][i] = static_cast<float>(taps_onto(oy, oy - 1 + i, H));
  }

  for (int c = 0; c < C; ++c) {
    const float* sx = s_in + c * IN_ROWS * IN_LD;
    const float* sy = s_in + (C + c) * IN_ROWS * IN_LD;

    // ---- coefficient maps over the tile grown by 1 ------------------------
    if (tid < CO_THREADS) {
      const int q = tid % CO_COLS, r0 = (tid / CO_COLS) * CO_STRIP;
      const int qx = x0 - 1 + q;
      float up2[5], up1[5];
#pragma unroll
      for (int j = 0; j < CO_STRIP + 2; ++j) {
        // Input row r0 + j, window columns q+2 .. q+4 (image x0-2+q .. x0+q).
        float h[5];
        row_sums(sx + (r0 + j) * IN_LD + q + 2, sy + (r0 + j) * IN_LD + q + 2, h);
        if (j >= 2) {
          const int r = r0 + j - 2, qy = y0 - 1 + r;
          float P = 0.f, Q = 0.f, R = 0.f, S = 0.f;
          if (qy >= 0 && qy < H && qx >= 0 && qx < W) {
            const float mx = (up2[0] + up1[0] + h[0]) * k9;
            const float my = (up2[1] + up1[1] + h[1]) * k9;
            const float exx = (up2[2] + up1[2] + h[2]) * k9;
            const float eyy = (up2[3] + up1[3] + h[3]) * k9;
            const float exy = (up2[4] + up1[4] + h[4]) * k9;
            const float sigx = exx - mx * mx;
            const float sigy = eyy - my * my;
            const float sxy = exy - mx * my;
            const float A1 = 2.f * mx * my + kC1;
            const float B1 = 2.f * sxy + kC2;
            const float A2 = mx * mx + my * my + kC1;
            const float B2 = sigx + sigy + kC2;
            const float inv = 1.f / (A2 * B2);
            const float ratio = A1 * B1 * inv;  // SSIM = num / den
            const float s = (1.f - ratio) * 0.5f;
            // Zero gradient where the clip to [0, 1] saturates.
            const float a = (s >= 0.f && s <= 1.f) ? s_g[r * CO_LD + q] * ssim_scale : 0.f;
            const float kN = -0.5f * a * inv;        // dL/d num
            const float kD = 0.5f * a * ratio * inv; // dL/d den
            P = (kN * 2.f * my * (B1 - A1) + kD * 2.f * mx * (B2 - A2)) * k9;
            Q = (kN * 2.f * mx * (B1 - A1) + kD * 2.f * my * (B2 - A2)) * k9;
            R = kD * A2 * k9;
            S = kN * 2.f * A1 * k9;
          }
          const int at = r * CO_LD + q;
          s_co[at] = P;
          if (want_target) s_co[CO_MAP + at] = Q;
          s_co[2 * CO_MAP + at] = R;
          s_co[3 * CO_MAP + at] = S;
        }
#pragma unroll
        for (int m = 0; m < 5; ++m) {
          up2[m] = up1[m];
          up1[m] = h[m];
        }
      }
    }
    __syncthreads();

    // ---- transposed stencil: column pass with wc, row pass with wr --------
    float hP[STRIP + 2] = {}, hQ[STRIP + 2] = {}, hR[STRIP + 2] = {}, hS[STRIP + 2] = {};
#pragma unroll
    for (int k = 0; k < STRIP + 2; ++k) {
      const float* co = s_co + (ly0 + k) * CO_LD + lx;
      hP[k] = wc[0] * co[0] + wc[1] * co[1] + wc[2] * co[2];
      hQ[k] = want_target ? wc[0] * co[CO_MAP] + wc[1] * co[CO_MAP + 1] + wc[2] * co[CO_MAP + 2] : 0.f;
      hR[k] = wc[0] * co[2 * CO_MAP] + wc[1] * co[2 * CO_MAP + 1] + wc[2] * co[2 * CO_MAP + 2];
      hS[k] = wc[0] * co[3 * CO_MAP] + wc[1] * co[3 * CO_MAP + 1] + wc[2] * co[3 * CO_MAP + 2];
    }
    const size_t plane = (static_cast<size_t>(b) * C + c) * HW;
#pragma unroll
    for (int t = 0; t < STRIP; ++t) {
      const int ly = ly0 + t, oy = y0 + ly;
      if (oy < H && ox < W) {
        const float sP = wr[t][0] * hP[t] + wr[t][1] * hP[t + 1] + wr[t][2] * hP[t + 2];
        const float sR = wr[t][0] * hR[t] + wr[t][1] * hR[t + 1] + wr[t][2] * hR[t + 2];
        const float sS = wr[t][0] * hS[t] + wr[t][1] * hS[t + 1] + wr[t][2] * hS[t + 2];
        const float xr = sx[(ly + 2) * IN_LD + lx + 4], yr = sy[(ly + 2) * IN_LD + lx + 4];
        // d|t - p| / dp, with jnp.abs's subgradient at a tie: -1 where p == t.
        const float l1 = s_g[(ly + 1) * CO_LD + lx + 1] * l1_scale * (xr - yr > 0.f ? 1.f : -1.f);
        const size_t at = plane + oy * W + ox;
        d_pred[at] = sP + 2.f * xr * sR + yr * sS + l1;
        if (want_target) {
          const float sQ = wr[t][0] * hQ[t] + wr[t][1] * hQ[t + 1] + wr[t][2] * hQ[t + 2];
          d_target[at] = sQ + 2.f * yr * sR + xr * sS - l1;
        }
      }
    }
    if (c + 1 < C) __syncthreads();
  }
}

size_t bwd_smem_bytes(int C) {
  return sizeof(float) * (static_cast<size_t>(2 * C) * IN_ROWS * IN_LD + 5 * CO_MAP);
}

}  // namespace

extern "C" int photometric_fwd(const float* pred, const float* target, float* out, int B, int C,
                               int H, int W, float ssim_weight, void* stream) {
  if (B > 0 && C > 0 && H > 0 && W > 0) {
    const int strips = (H + FWD_ROWS - 1) / FWD_ROWS;
    const dim3 grid((W + FWD_SPAN - 1) / FWD_SPAN, (strips + FWD_WARPS - 1) / FWD_WARPS, B);
    photometric_fwd_kernel<<<grid, dim3(32, FWD_WARPS), 0, static_cast<cudaStream_t>(stream)>>>(
        pred, target, out, C, H, W, ssim_weight);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int photometric_bwd(const float* pred, const float* target, const float* g_out,
                               float* d_pred, float* d_target, int B, int C, int H, int W,
                               float ssim_weight, void* stream) {
  if (B > 0 && C > 0 && H > 0 && W > 0) {
    // Opt in once per device to the card's largest shared memory per block.
    constexpr int kMaxDevices = 64;
    static int optin[kMaxDevices] = {0};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (optin[dev] == 0) {
      int bytes = 0;
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      cudaFuncSetAttribute(photometric_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      optin[dev] = bytes;
    }
    const size_t smem = bwd_smem_bytes(C);
    if (smem > static_cast<size_t>(optin[dev])) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(pred) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(target) % 16 == 0;
    const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
    photometric_bwd_kernel<<<grid, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        pred, target, g_out, d_pred, d_target, C, H, W, ssim_weight, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
