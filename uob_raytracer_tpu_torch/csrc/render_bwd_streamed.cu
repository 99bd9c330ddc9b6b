// Streamed path-replay backward kernel for Hopper (sm_90a): the large-scene
// variant of render_bwd.cu, one launch per gradient for any triangle count,
// and the segmented sum that follows it.
//
// Replaces the streamed mode of the TPU kernel kernels/render_bwd.py:
// _bwd_kernel(streamed=True) of the JAX package. It computes the same
// cotangents as the whole-table kernel, per ray by the same code
// (bwd_body.cuh). Two things differ:
//
// - The gather. The TPU kernel finds a lane's row by scanning the whole
//   streamed table at every site, because a TPU lane cannot index memory by
//   itself. A CUDA thread can: it loads row `id` of tri [T,19] or sph [S,12]
//   straight from device memory. No tile staging, no table scan.
// - The accumulator. The whole-table kernel keeps 16 floats per object and
//   warp in shared memory; at thousands of triangles that does not fit, and
//   its per-block partial sums would take gigabytes. Here a triangle's
//   cotangent leaves per ray and site: dlane [(1 + bounces) * A * rows * W,
//   16], row ((site * A + a) * n_pix + p), site 0 the primary hit and site
//   1 + k bounce step k, columns v0 e1 e2 n rgb | 0. The wrapper hands the
//   buffer in zeroed and the kernel writes only the sites that hit a
//   triangle, so dead sites hold zeros. The few spheres and the camera row
//   keep the whole-table design: warp-shuffle sums into per-warp
//   accumulators in shared memory and one partial row per block,
//   [n_sph*16 + 21], summed over blocks by the wrapper. Those sums are made
//   in the order of the whole-table kernel, so on a scene both kernels can
//   run the sphere and camera cotangents come out bit-equal.
//
// The per-site rows are then summed per triangle by segment_sum_kernel,
// below: the wrapper sorts the sites' triangle ids once (a stable sort, so
// equal ids keep their site order) and gives each triangle's run of sorted
// positions to one warp, which adds the run's rows in a fixed order. No
// float atomics anywhere: two runs on the same inputs give bit-equal
// gradients, which index_add_ / scatter_add_ on the card do not.
//
// What bounds it on this card: the replay's FP32 work as in render_bwd.cu,
// plus 64 B of stores per triangle site; the segmented sum is bound by the
// bytes it gathers (64 B per live site).

#include "bwd_common.cuh"

namespace {

// The streamed kernel's tables: rows straight from device memory, triangle
// cotangents to the per-site buffer, sphere cotangents to the warp's
// accumulator in shared memory.
struct StreamedTables {
  const float* tri;
  const float* sph;
  float* wacc;   // [n_sph * 16] sphere sums of this warp
  float* dlane;  // this pixel's first row: dlane + p * 16
  size_t n_pix;
  int n_tri, A;

  __device__ __forceinline__ Row load(int id) const {
    if (id < 0) return miss_row();
    Row r;
    r.valid = true;
    r.is_sph = id >= n_tri;
    if (!r.is_sph) {
      const float* R = tri + (size_t)id * kTriCols;
      r.v0 = load3(R);
      r.e1 = load3(R + 3);
      r.e2 = load3(R + 6);
      r.n = load3(R + 9);
      r.rgb = load3(R + 12);
      r.mat = R[15];
      r.r2 = 0.0f;
    } else {
      const float* S = sph + (id - n_tri) * kSphCols;
      r.v0 = load3(S);
      r.e1 = r.e2 = r.n = zero3();
      r.rgb = load3(S + 4);
      r.mat = S[7];
      r.r2 = S[3];
    }
    return r;
  }

  __device__ __forceinline__ void scatter(int site, int a, int id, const RowGrad& g) {
    if (id >= 0 && id < n_tri) {
      float4* o = reinterpret_cast<float4*>(dlane + ((size_t)site * A + a) * n_pix * kGradCols);
      o[0] = make_float4(g.v0.x, g.v0.y, g.v0.z, g.e1.x);
      o[1] = make_float4(g.e1.y, g.e1.z, g.e2.x, g.e2.y);
      o[2] = make_float4(g.e2.z, g.n.x, g.n.y, g.n.z);
      o[3] = make_float4(g.rgb.x, g.rgb.y, g.rgb.z, 0.0f);
    }
    warp_scatter(wacc, id >= n_tri ? id - n_tri : -1, g);
  }
};

__global__ void __launch_bounds__(kThreads)
    render_bwd_streamed_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_sph,
                               const float* __restrict__ g_cam, const float* __restrict__ g_img,
                               const int* __restrict__ pid, const float* __restrict__ lit_in,
                               const int* __restrict__ bid, float* __restrict__ dlane,
                               float* __restrict__ partial, float* __restrict__ img, Params P) {
  extern __shared__ float smem[];
  const int acc_cols = P.n_sph * kGradCols + kCamCols;
  float* cam = smem;
  float* acc = cam + kCamCols;  // [kWarps][acc_cols]

  for (int i = threadIdx.x; i < kCamCols; i += blockDim.x) cam[i] = g_cam[i];
  for (int i = threadIdx.x; i < kWarps * acc_cols; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  float* wacc = acc + (threadIdx.x >> 5) * acc_cols;
  StreamedTables tb;
  tb.tri = g_tri;
  tb.sph = g_sph;
  tb.wacc = wacc;
  tb.n_pix = (size_t)P.rows * P.width;
  // a thread past the ragged edge reads no id >= 0, so it never stores
  tb.dlane = dlane + ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * kGradCols;
  tb.n_tri = P.n_tri;
  tb.A = P.aa_x * P.aa_y;
#define REPLAY_LOAD_ROW(id) tb.load(id)
#define REPLAY_SCATTER(site, a, id, g) tb.scatter(site, a, id, g)
#define REPLAY_WCAM (wacc + P.n_sph * kGradCols)
#include "bwd_body.cuh"
#undef REPLAY_LOAD_ROW
#undef REPLAY_SCATTER
#undef REPLAY_WCAM

  // --- the block's partial row: its warps' accumulators added in order ---
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * acc_cols;
  for (int i = threadIdx.x; i < acc_cols; i += blockDim.x) {
    float s = acc[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += acc[w * acc_cols + i];
    out[i] = s;
  }
}

// out[t] = the sum of rows[order[j]] over j in [bounds[t], bounds[t + 1]),
// for t < n_seg: one warp per segment. Lane l owns column l & 15 and every
// second row of the run (l >> 4), adds them front to back, and the two
// halves meet in one shuffle: the order of the additions depends on the
// run alone.
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const float* __restrict__ rows, const long long* __restrict__ order,
                       const long long* __restrict__ bounds, float* __restrict__ out, int n_seg) {
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_seg) return;  // whole warps leave together
  const int lane = threadIdx.x & 31, c = lane & 15;
  const long long end = bounds[t + 1];
  float s = 0.0f;
  // unrolled so that several gathers are in flight; the adds keep their order
#pragma unroll 8
  for (long long j = bounds[t] + (lane >> 4); j < end; j += 2)
    s += rows[order[j] * kGradCols + c];
  s += __shfl_xor_sync(kFull, s, 16);
  if (lane < kGradCols) out[(size_t)t * kGradCols + c] = s;
}

}  // namespace

// Launches one streamed backward pass on `stream`; ip, fp, g, pid, lit, bid
// and img as render_bwd_launch (render_bwd.cu). dlane [(1 + bounces) * A *
// rows * W, 16] must arrive zeroed; partial [ceil(rows*W / 128), n_sph*16 +
// 21] is overwritten. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue when bounces exceeds the kernel's cap.
extern "C" int render_bwd_streamed_launch(const float* tri, const float* sph, const float* cam,
                                          const float* g, const int* pid, const float* lit,
                                          const int* bid, float* dlane, float* partial,
                                          float* img, const int* ip, const float* fp,
                                          void* stream) {
  const Params P = make_params(ip, fp);
  if (P.bounces > kMaxBounces) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)P.rows * P.width;
  if (n_pix == 0) return 0;
  const size_t smem =
      sizeof(float) * (kCamCols + kWarps * ((size_t)P.n_sph * kGradCols + kCamCols));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_bwd_streamed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n_pix + kThreads - 1) / kThreads);
  render_bwd_streamed_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      tri, sph, cam, g, pid, lit, bid, dlane, partial, img, P);
  return (int)cudaGetLastError();
}

// Launches the segmented sum on `stream`: rows [n_rows, 16] float32, order
// (int64 row indices, sorted by segment) and bounds [n_seg + 1] (int64
// positions in order) on the device; out [n_seg, 16] is overwritten.
extern "C" int segment_sum_launch(const float* rows, const long long* order,
                                  const long long* bounds, float* out, int n_seg, void* stream) {
  if (n_seg == 0) return 0;
  const unsigned blocks = (unsigned)((n_seg + kWarps - 1) / kWarps);
  segment_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(rows, order, bounds, out,
                                                                   n_seg);
  return (int)cudaGetLastError();
}
