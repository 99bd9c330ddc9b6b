// One AA ray of the structure twin: the body of the free twin's loop over
// a pixel's rays and of the chain twin's walk over its items (bwd_twin.cu,
// twin_body.cuh), as bwd_ray.cuh is K2's. Code, included INSIDE a
// __global__ function; every lane of a warp runs it (a lane without a ray
// included: it carries id -1 and takes part in the shuffles).
//
// In scope where it is included:
//   bool Chain (constexpr)   false: the free twin, no chain storage and no
//                            step code; true: the chain twin
//   int Var, NPool (constexpr)   the instance (kTwinAsK2 or a split piece)
//                            and the pool size
//   int a; size_t p, n_pix; bool in_img; int A   the ray's AA index, its
//                            pixel, the band's pixel count, whether the
//                            ray is real, the AA ray count
//   float gx                 the pixel's cotangent, column 0
//   the kernel's pid, lit_in (and bid with Chain), D, T; the staged
//   table obj; this warp's accumulator wacc; float dcam[kCamCols] (added
//   to); with Chain the chain storage float saved[kRegBounces][12] and int
//   saved_id[kRegBounces]; and two macros:
//   TWIN_CAM(i)                      the camera row's value i (0..20)
//   TWIN_SCATTER_PRIMARY(id, g)      the primary site's scatter of RowGrad
//                                    g (all 32 lanes)
// It declares float ray_img[3]: this ray's term of the pixel's image.

    float ray_img[3];
    {
      const int id0 = in_img ? pid[a * n_pix + p] : -1;
      const float lit = in_img ? lit_in[a * n_pix + p] : 0.0f;
      float xs[kObjCols];
      twin_row(obj, id0, xs);
      const bool chain = Chain && id0 >= 0 && xs[15] <= 0.0f;
      xs[0] = (xs[0] + lit * 1e-6f) + gx * 1e-3f;

      float accs[kTwinSlots];
      accs[0] = xs[0];
#pragma unroll
      for (int s = 1; s < kTwinSlots; ++s) accs[s] = xs[0] * (float)(1.0 + 1e-6 * s);

      // --- first half of the main chain; the pool keeps its snapshots ---
      float pool[NPool > 0 ? NPool : 1];
#pragma unroll
      for (int it = 0; it < kTwinHalf; ++it) {
        const float x = xs[it % kObjCols];
        float mids[kTwinSlots];
#pragma unroll
        for (int s = 0; s < kTwinSlots; ++s) mids[s] = accs[s];
        if (it < T.n_half) run_slots(accs, mids, x, T.divs[it], T.slots[it]);
#pragma unroll
        for (int s = 0; s < kTwinSlots; ++s) {
          const int j = 2 * (it * kTwinSlots + s);
          if (j < NPool) pool[j] = accs[s];
          if (j + 1 < NPool) pool[j + 1] = mids[s];
        }
      }
      const float a_mid = accs[0];

      float dcarr = a_mid;
      if constexpr (Chain) {
        // --- forward sweep: the steps the record says this ray ran ---
        float carr = a_mid;
        int n_exec = 0;
        bool active = chain;
        while (active && n_exec < D.bounces) {
          const int idk = bid[((size_t)n_exec * A + a) * n_pix + p];
          float row[kObjCols];
          twin_row(obj, idk, row);
          const int slot = Var == kTwinNoChain ? 0 : n_exec;
          float* sv = saved[slot];
#pragma unroll
          for (int c = 0; c < 11; ++c) sv[c] = row[c];
          sv[11] = carr;
          saved_id[slot] = idk;
          ++n_exec;
          carr = carr + row[0];
          active = idk >= 0 && row[15] <= 0.0f;
        }

        // --- reverse sweep, to the warp's deepest chain ---
        dcarr = carr;
        int k_max = n_exec;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) k_max = max(k_max, __shfl_xor_sync(kFull, k_max, off));
        for (int k = k_max - 1; k >= 0; --k) {
          float gr[kGradCols];
#pragma unroll
          for (int c = 0; c < kGradCols; ++c) gr[c] = 0.0f;
          int sid = -1;
          if (k < n_exec) {
            const int slot = Var == kTwinNoChain ? 0 : k;
            const float* sv = saved[slot];
            const int id = saved_id[slot];
            float row[kObjCols];
            twin_row(obj, id, row);
            const float x = row[0];
            const float y = dcarr + sv[11];
            float sa[kStepAccs];
#pragma unroll
            for (int s = 0; s < kStepAccs; ++s) sa[s] = y * (float)(1.0 + 1e-7 * s);
#pragma unroll 1
            for (int t = 0; t < T.n_step; ++t) {
#pragma unroll
              for (int s = 0; s < kStepAccs; ++s) {
                float mid;
                sa[s] = twin_iter(sa[s], x, s == 0 || s == 3, mid);
              }
            }
#pragma unroll
            for (int c = 0; c < 12; ++c) gr[c] = sa[c & 3] * sv[c];
#pragma unroll
            for (int c = 12; c < 15; ++c) gr[c] = sa[c & 3];
            gr[15] = 1.0f;
            dcarr = sa[0];
            sid = id;
          }
          twin_scatter<Var>(wacc, sid, as_grad(gr));
        }
      }

      // --- second half of the main chain ---
      accs[0] = dcarr + a_mid;
#pragma unroll
      for (int i2 = 0; i2 < kTwinHalf; ++i2) {
        const float x = xs[(kTwinHalf + i2) % kObjCols];
        float mids[kTwinSlots];
        if (i2 < T.n_second)
          run_slots(accs, mids, x, T.divs[kTwinHalf + i2], T.slots[kTwinHalf + i2]);
      }

      // --- the primary site's scatter, the camera, the image term ---
      {
        float gr[kGradCols];
#pragma unroll
        for (int c = 0; c < 15; ++c) gr[c] = accs[c % kTwinSlots];
        gr[15] = 1.0f;
        TWIN_SCATTER_PRIMARY(id0, as_grad(gr));
      }
      // a lane without a ray adds no camera term (its scatters carry id -1)
      if (in_img) {
#pragma unroll
        for (int c = 0; c < kCamCols; ++c)
          dcam[c] = dcam[c] + (accs[c % kTwinSlots] + TWIN_CAM(c));
      }
      float pacc = accs[0];
      if constexpr (NPool > 0) {
        TreeSum<NPool>::fold(pool);
        pacc = pacc + pool[0];
      }
      const float pe = pacc * 1e-6f;
#pragma unroll
      for (int c = 0; c < 3; ++c) ray_img[c] = accs[c] + pe;
    }
