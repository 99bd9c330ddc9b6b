// Path-replay backward kernel for Hopper (sm_90a): one launch per gradient.
//
// Replaces the TPU kernel kernels/render_bwd.py:_bwd_kernel of the JAX
// package (whole-table mode). From the packed scene tables, the image
// cotangent g and the forward kernel's decision record (pid, lit, bid) it
// computes the cotangents of the tables: per ray it gathers the objects the
// ray hit, replays the lean reconstruction of the ray's radiance
// (ops/replay.py: ray generation + primary hit, the bounce chain, the
// shading tail) and runs the adjoint of that replay in reverse.
//
// The TPU kernel calls jax.vjp inside its body; CUDA has no autodiff, so
// every adjoint here is derived by hand. The rules that make the gradient
// the framework's (PARITY.md "Gradient semantics"): a select passes its
// cotangent to the chosen branch only; mat, is_sph, valid, medium, lit and
// the tir / use_refl / dead decisions are frozen; max(x, 0) passes where
// x > 0; the guards disc == 0, k == 0, detA == 0, q == 0, a_q == 0,
// pl2 == 0 and radius_sq == 0 give a zero derivative; a triangle's normal
// is the packed table's column 9..11 and its cotangent goes there (the
// wrapper pulls it back onto the vertices through pack_scene). Division
// and sqrt are IEEE with their plain derivatives.
//
// Design (simple first):
// - One thread per pixel, looping over its A rays as the forward kernel
//   does. Per ray: a forward sweep over the bounce steps the ray really ran
//   (the record's depth, not the budget) that keeps the 12 floats a step's
//   adjoint needs (cur_d, cur_pos, cur_nrm, cur_mat, medium, weight) in
//   per-thread storage, the shading adjoint, the reverse sweep, and the
//   adjoint of the primary hit and the ray generation. The TPU kernel's
//   VMEM chain scratch, sized from the config's bounces, becomes that
//   per-thread array in the register instance (Deep = false), sized at
//   compile time to kRegBounces steps; a deeper config launches the deep
//   instance (Deep = true), whose chain lives in a device buffer the
//   wrapper allocates (bwd_common.cuh: DeepSteps), so any bounce count
//   runs and the default instance keeps its registers.
// - The object rows (28 x 17 floats on the Cornell box) are staged into
//   shared memory as one unified table, so a gather is one indexed read:
//   the TPU kernel's presence-bit gather loop and its de Bruijn LUT are not
//   needed for gathering.
// - The TPU kernel accumulates into tables that persist across its
//   sequential grid. Blocks run concurrently here, so each block reduces
//   its own rays' cotangents and writes one row of partial sums
//   [n_obj*16 + 21]; the sum over blocks is a torch.sum in the wrapper.
//   No float atomics anywhere: within a warp, the lanes that hit the same
//   object at the same site are summed by a shuffle butterfly (the warp
//   visits only the objects its rays hit, which is the presence word's
//   second job), lane 0 adds the result to the warp's accumulator in
//   shared memory, and the block adds its four warps in order. Two runs on
//   the same inputs give bit-equal gradients.
// - The reverse sweep runs to the deepest chain of the warp, with shallower
//   lanes idle, so that all 32 lanes meet at every shuffle.
//
// What bounds it on this card: FP32 issue and the shuffle reductions; the
// record it reads (4 + 4 + 4*bounces bytes per ray) and the partial sums it
// writes are small beside that.
//
// The per-ray replay and its adjoint live in bwd_common.cuh and
// bwd_body.cuh, shared with the streamed kernel (render_bwd_streamed.cu) for scenes whose accumulators do
// not fit shared memory.
//
// Built with --fmad=false like the forward kernel, and with the replay's
// forward arithmetic in the order of ops/replay.py, so that the recomputed
// decisions (tir, the root chosen, the side of the normal) are those of the
// plain version bit for bit.

#include "bwd_common.cuh"

namespace {

// The row of object `id` from the staged table; -1 reads the miss row.
__device__ __forceinline__ Row load_row(const float* obj, int n_tri, int id) {
  if (id < 0) return miss_row();
  Row r;
  r.valid = true;
  r.is_sph = id >= n_tri;
  const float* R = obj + id * kObjCols;
  r.v0 = load3(R);
  r.e1 = load3(R + 3);
  r.e2 = load3(R + 6);
  r.n = load3(R + 9);
  r.rgb = load3(R + 12);
  r.mat = R[15];
  r.r2 = R[16];
  return r;
}

// The whole-table kernel's tables: rows from the staged unified table,
// cotangents into the warp's accumulator in shared memory.
struct WholeTables {
  const float* obj;
  float* wacc;
  int n_tri;
  __device__ __forceinline__ Row load(int id) const { return load_row(obj, n_tri, id); }
  __device__ __forceinline__ void scatter(int, int, int id, const RowGrad& g) {
    warp_scatter(wacc, id, g);
  }
};

template <bool Deep>
__global__ void __launch_bounds__(kThreads)
    render_bwd_kernel(const float* __restrict__ g_tri, const float* __restrict__ g_sph,
                      const float* __restrict__ g_cam, const float* __restrict__ g_img,
                      const int* __restrict__ pid, const float* __restrict__ lit_in,
                      const int* __restrict__ bid, float* __restrict__ partial,
                      float* __restrict__ img, float* __restrict__ chain, Params P) {
  extern __shared__ float smem[];
  const int n_obj = P.n_tri + P.n_sph;
  const int acc_cols = n_obj * kGradCols + kCamCols;
  float* obj = smem;
  float* cam = obj + n_obj * kObjCols;
  float* acc = cam + kCamCols;  // [kWarps][acc_cols]

  // --- stage the unified object table and zero the accumulators ---
  for (int i = threadIdx.x; i < n_obj * kObjCols; i += blockDim.x) {
    const int o = i / kObjCols, c = i - o * kObjCols;
    float v;
    if (o < P.n_tri) {
      v = c < 16 ? g_tri[o * kTriCols + c] : 0.0f;  // v0 e1 e2 n rgb mat | r2 = 0
    } else {
      const float* S = g_sph + (o - P.n_tri) * kSphCols;
      v = c < 3 ? S[c] : c < 12 ? 0.0f : c < 15 ? S[4 + (c - 12)] : c == 15 ? S[7] : S[3];
    }
    obj[i] = v;
  }
  for (int i = threadIdx.x; i < kCamCols; i += blockDim.x) cam[i] = g_cam[i];
  for (int i = threadIdx.x; i < kWarps * acc_cols; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  float* wacc = acc + (threadIdx.x >> 5) * acc_cols;
  WholeTables tb;
  tb.obj = obj;
  tb.wacc = wacc;
  tb.n_tri = P.n_tri;
#define REPLAY_LOAD_ROW(id) tb.load(id)
#define REPLAY_SCATTER(site, a, id, g) tb.scatter(site, a, id, g)
#define REPLAY_WCAM (wacc + n_obj * kGradCols)
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

}  // namespace

// Launches one backward pass on `stream`. ip and fp are HOST arrays (their
// fields are listed at make_params in bwd_common.cuh).
// g [rows, W, 3]; pid, lit [A, rows, W]; bid [bounces, A, rows, W] (may be
// null when bounces == 0); partial [ceil(rows*W / 128), (n_tri+n_sph)*16 + 21]
// is overwritten; img [rows, W, 3] receives the replayed radiance when
// want_img is set (else it may be null). Up to kRegBounces bounces the
// register instance runs and chain may be null; a deeper config runs the
// deep instance, which needs chain: kChainFloats * bounces * 128 *
// ceil(rows*W / 128) floats of scratch (contents on entry do not matter).
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue when a
// deep config comes without its chain.
extern "C" int render_bwd_launch(const float* tri, const float* sph, const float* cam,
                                 const float* g, const int* pid, const float* lit,
                                 const int* bid, float* partial, float* img, float* chain,
                                 const int* ip, const float* fp, void* stream) {
  const Params P = make_params(ip, fp);
  const bool deep = P.bounces > kRegBounces;
  if (deep && chain == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)P.rows * P.width;
  if (n_pix == 0) return 0;
  const size_t n_obj = (size_t)P.n_tri + P.n_sph;
  const size_t smem =
      sizeof(float) * (n_obj * kObjCols + kCamCols + kWarps * (n_obj * kGradCols + kCamCols));
  const auto kernel = deep ? render_bwd_kernel<true> : render_bwd_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n_pix + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(tri, sph, cam, g, pid, lit, bid,
                                                          partial, img, chain, P);
  return (int)cudaGetLastError();
}
