// The chain twin's body, included as text INSIDE each chain twin kernel
// (bwd_twin.cu) after its signature, as K2c's body sits in
// render_bwd_kernel: K7c itself and the split instances that vary one
// piece of K2c's structure. One thread per AA ray: the grid walks chunks
// of twin_ppb(A) pixels, block b taking chunks b, b + gridDim.x, ...; in a
// chunk ray a of pixel l is item a * ppb + l and thread t takes items t, t
// + 128, ..., so a warp holds one AA index of 32 pixels. With a list (the
// free twin's, and off [n_src], the inclusive sums of its counts) chunk c
// holds listed pixels c * ppb ..., each item finding its pixel by K2c's
// binary search over off (Var kTwinNoSearch: read from pixels, the list
// compacted); a block with no chunk writes zeros and stops. Without, chunk
// c holds pixels c * ppb ...
// In scope: the kernel's parameters (table, g_img, pid, lit_in, bid,
// partial, img, list, off, pixels, D, T), int NPool (the pool size) and
// int Var (kTwinAsK2, or the split piece: kTwinNoShfl, kTwinNoChain,
// kTwinNoSearch).
  constexpr bool Chain = true;
  const size_t n_pix = (size_t)D.rows * D.width;
  const int n_src = (int)((n_pix + kThreads - 1) / kThreads);
  const size_t n_work = list != nullptr ? (size_t)off[n_src - 1] : n_pix;
  const int A = D.aa;
  const int ppb = twin_ppb(A);
  const size_t n_chunks = (n_work + ppb - 1) / ppb;
  if (blockIdx.x >= n_chunks) {
    twin_zero_partial_row(partial, D);
    return;
  }
  TWIN_STAGE();
  float* col = acc + kWarps * acc_cols;                  // [A][3][ppb]: the rays' image terms
  int* pix = reinterpret_cast<int*>(col + A * 3 * ppb);  // [ppb]: the chunk's pixels

  const float fA = (float)A;
  float dcam[kCamCols];
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) dcam[i] = 0.0f;
  float saved[kRegBounces][12];
  int saved_id[kRegBounces];

  for (size_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    for (int item = threadIdx.x; item < ppb * A; item += kThreads) {
      const int a = item / ppb, lp = item - a * ppb;
      const size_t j = chunk * ppb + lp;
      // a lane past the last pixel stays: it carries no ray but takes part
      // in the warp's shuffles
      const bool in_img = j < n_work;
      size_t p = j;
      if (list != nullptr && in_img) {
        if constexpr (Var == kTwinNoSearch) {
          p = (size_t)pixels[j];
        } else {
          int lo = 0, hi = n_src - 1;  // the first source block past j
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if ((size_t)off[mid] > j)
              hi = mid;
            else
              lo = mid + 1;
          }
          p = (size_t)list[(size_t)lo * kThreads + (j - (lo ? (size_t)off[lo - 1] : 0))];
        }
      }
      if (a == 0) pix[lp] = in_img ? (int)p : -1;
      const float gx = in_img ? g_img[p * 3] : 0.0f;
#define TWIN_CAM(i) cam[i]
#define TWIN_SCATTER_PRIMARY(id, g) twin_scatter<Var>(wacc, id, g)
#include "twin_ray.cuh"
#undef TWIN_CAM
#undef TWIN_SCATTER_PRIMARY
      col[(a * 3 + 0) * ppb + lp] = ray_img[0];
      col[(a * 3 + 1) * ppb + lp] = ray_img[1];
      col[(a * 3 + 2) * ppb + lp] = ray_img[2];
    }
    __syncthreads();
    // the image: each pixel's ray terms added in ray order, ((0 + c0) +
    // c1) + ..., and divided by A, as one thread looping over them
    for (int l = threadIdx.x; l < ppb; l += kThreads) {
      const int q = pix[l];
      if (q < 0) break;
      float s[3] = {0.0f, 0.0f, 0.0f};
      for (int a = 0; a < A; ++a) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s[c] = s[c] + col[(a * 3 + c) * ppb + l];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) img[(size_t)q * 3 + c] = s[c] / fA;
    }
    __syncthreads();  // col and pix are the next chunk's
  }

  // --- camera columns: the warp's 21 sums, as K2's (the no-shuffle
  // split: lane 0's own) ---
  if constexpr (Var != kTwinNoShfl) {
    warp_camera(wacc + D.n_obj * kGradCols, dcam);
  } else {
#pragma unroll
    for (int i = 0; i < kCamCols; ++i)
      if ((threadIdx.x & 31) == 0) wacc[D.n_obj * kGradCols + i] = dcam[i];
  }

  TWIN_WRITE_PARTIAL_ROW();
