// One pixel's rays: the replay and its adjoint, as a body of code that the
// chain-free kernel of render_bwd.cu includes INSIDE its __global__
// function, once for each tile a block takes (after it has staged its
// tables and synchronised), not a header of declarations. What one ray
// does (the loop's body) is bwd_ray.cuh, which the chain kernel and the
// streamed kernel, one thread per AA ray, include by themselves. The
// code is shared as text because nvcc compiles it 19% slower (0.49 against
// 0.41 ms on the full_1024 frame, H100) when it sits in a function, even
// one forced inline. Every thread of the block runs it, threads without a
// pixel included (they carry no ray but take part in the warp's shuffles).
//
// In scope where it is included:
//   bool Chain (constexpr)   false: the chain-free instance, for pixels
//                            none of whose rays bounces; no chain storage,
//                            no forward or reverse sweep
//   bool Deep (constexpr)    false: the register instance, whose bounce
//                            chain is a per-thread array of kRegBounces
//                            steps; true: the deep instance, whose chain is
//                            the device buffer float* chain of kChainFloats
//                            * bounces * chain_stride floats, laid out as
//                            DeepSteps says (chain_stride: size_t, at least
//                            the band's pixels)
//   size_t n_pix, p; bool in_img   the band's pixel count; this thread's
//                            pixel, and whether it has one (p < n_pix)
//   float dcam[kCamCols]     the thread's camera cotangents (added to; the
//                            kernel sums them over the warp after its last
//                            tile)
//   Params P; const float* cam (the staged camera row); the kernel's g_img,
//   pid, lit_in, bid, img and chain pointers; and two macros, undefined
//   again after the include:
//   REPLAY_LOAD_ROW(id)              the Row of object id (-1: the miss row)
//   REPLAY_SCATTER(site, a, id, g)   adds RowGrad g to object id's cotangent
//                                    for site (0 primary, 1 + k bounce step
//                                    k) of AA ray a; id < 0: nothing to add;
//                                    reached by all 32 lanes of the warp
// The replayed radiance goes to img when P.want_img.

  const int py = in_img ? (int)(p / P.width) : 0;
  const int px = in_img ? (int)(p - (size_t)py * P.width) : 0;

  const V3 r0 = load3(cam), r1 = load3(cam + 3), r2 = load3(cam + 6);
  const V3 cam_pos = load3(cam + 9), light = load3(cam + 12);
  const V3 light_rgb = load3(cam + 15), indirect = load3(cam + 18);
  const int A = P.aa_x * P.aa_y;
  const float fA = (float)A, fS = (float)P.shadow_samples;
  const float bx0 = (float)px * (float)P.aa_x - P.half_w;
  const float by0 = (float)(P.row0 + py) * (float)P.aa_y - P.half_h;
  V3 gpix = zero3();
  if (in_img) gpix = load3(g_img + p * 3);
  // cotangent of one ray's color: the AA mean is sum / A
  const V3 dcolor = make(gpix.x / fA, gpix.y / fA, gpix.z / fA);

  V3 img_acc = zero3();
  ChainSteps<Deep> saved;
  ChainIds<Deep> saved_id;
  deep_chain<Deep>(saved, saved_id, chain, p, chain_stride);

  for (int a = 0; a < A; ++a) {
#include "bwd_ray.cuh"
  }

  if (P.want_img && in_img) {
    img[p * 3 + 0] = img_acc.x / fA;
    img[p * 3 + 1] = img_acc.y / fA;
    img[p * 3 + 2] = img_acc.z / fA;
  }
