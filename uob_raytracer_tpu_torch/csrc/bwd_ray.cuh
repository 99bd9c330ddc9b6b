// One AA ray's replay and its adjoint: the body of bwd_body.cuh's loop over
// a pixel's rays (the chain-free kernel), and what the chain kernel
// (render_bwd.cu) and the streamed kernel (render_bwd_streamed.cu), one
// thread per AA ray, include for their ray. Like bwd_body.cuh it is code,
// included INSIDE a __global__ function, and every lane of a warp runs it
// (a lane without a ray included: it takes part in the shuffles).
//
// In scope where it is included, beside what bwd_body.cuh lists:
//   int a                    the ray's AA index
//   int A; float fA, fS      the AA ray count, as int and float, and the
//                            shadow sample count
//   float bx0, by0           the pixel's first AA sample position
//   V3 r0, r1, r2, cam_pos, light, light_rgb, indirect   the camera row
//   V3 dcolor                the cotangent of this ray's colour
//   float dcam[kCamCols]     the thread's camera cotangents (added to)
//   V3 img_acc               the replayed radiance (this ray's is added)
//   ChainSteps<Deep> saved; ChainIds<Deep> saved_id   the chain storage
//                            (bool Chain, Deep: as bwd_body.cuh lists them)
    const int id0 = in_img ? pid[a * n_pix + p] : -1;
    const float lit = in_img ? lit_in[a * n_pix + p] : 0.0f;

    // --- forward: ray generation + primary reconstruction ---
    const V3 base = make(bx0 + (float)(a % P.aa_x), by0 + (float)(a / P.aa_x), P.focal);
    const V3 draw = make(dot(r0, base), dot(r1, base), dot(r2, base));
    V3 d = draw;
    float dlen = 1.0f;
    if (!P.cpu_ref) {
      dlen = sqrtf(dot(draw, draw));
      d = make(draw.x / dlen, draw.y / dlen, draw.z / dlen);
    }
    const Row prow = REPLAY_LOAD_ROW(id0);
    const HitOut ph = hit_fwd(prow, cam_pos, d);
    const bool prim_diffuse = P.cpu_ref ? prow.valid : (prow.valid && prow.mat > 0.0f);

    // --- forward: the bounce chain, as deep as this ray ran ---
    bool term_valid = false;
    V3 term_pos = zero3(), term_nrm = zero3(), term_rgb = zero3();
    float weight = 1.0f;
    int n_exec = 0;
    {
      V3 cur_d = d, cur_pos = ph.pos, cur_nrm = ph.nrm;
      float cur_mat = prow.mat, medium = P.ior_air;
      bool active = Chain && prow.valid && prow.mat <= 0.0f;
      while (active && n_exec < P.bounces) {
        const Step s = step_geometry(P, cur_d, cur_pos, cur_nrm, cur_mat, medium);
        if (s.dead) break;  // the step changes nothing and retires the ray
        const int idk = bid[((size_t)n_exec * A + a) * n_pix + p];
        auto sv = saved[n_exec];
        sv[0] = cur_d.x, sv[1] = cur_d.y, sv[2] = cur_d.z;
        sv[3] = cur_pos.x, sv[4] = cur_pos.y, sv[5] = cur_pos.z;
        sv[6] = cur_nrm.x, sv[7] = cur_nrm.y, sv[8] = cur_nrm.z;
        sv[9] = cur_mat, sv[10] = medium, sv[11] = weight;
        saved_id[n_exec] = idk;
        ++n_exec;
        weight = weight * s.w_step;
        const Row row = REPLAY_LOAD_ROW(idk);
        const HitOut h = hit_fwd(row, s.nstart, s.ndirn);
        if (row.valid && row.mat > 0.0f) {
          term_valid = true;
          term_pos = h.pos;
          term_nrm = h.nrm;
          term_rgb = h.rgb;
        }
        active = row.valid && row.mat <= 0.0f;
        if (active) {
          cur_d = s.ndirn;
          cur_pos = h.pos;
          cur_nrm = h.nrm;
          cur_mat = row.mat;
          medium = s.nmed;
        }
      }
    }

    // --- shading tail and its adjoint (lit frozen) ---
    V3 dp_pos = zero3(), dp_nrm = zero3(), dp_rgb = zero3();
    V3 dt_pos = zero3(), dt_nrm = zero3(), dt_rgb = zero3();
    float dw = 0.0f;
    if (prim_diffuse || term_valid) {
      const V3 sp_pos = sel(prim_diffuse, ph.pos, term_pos);
      const V3 sp_nrm = sel(prim_diffuse, ph.nrm, term_nrm);
      const V3 sdir = sub(light, sp_pos);
      const float radius_sq = dot(sdir, sdir);
      const bool rz = radius_sq == 0.0f;
      const float rs = rz ? 1.0f : radius_sq;
      const float cosl = dot(sdir, sp_nrm);
      const float m = nan_max(cosl, 0.0f);
      const float den = P.pi4 * rs;
      const float lam = rz ? 0.0f : m / den;
      const float dl_scale = lit * lam / fS;
      const V3 e = add(indirect, scale(dl_scale, light_rgb));
      V3 de;
      if (term_valid) {
        img_acc = add(img_acc, make(0.9f * e.x * term_rgb.x * weight,
                                    0.9f * e.y * term_rgb.y * weight,
                                    0.9f * e.z * term_rgb.z * weight));
        de = make(0.9f * term_rgb.x * weight * dcolor.x, 0.9f * term_rgb.y * weight * dcolor.y,
                  0.9f * term_rgb.z * weight * dcolor.z);
        dt_rgb = make(0.9f * e.x * weight * dcolor.x, 0.9f * e.y * weight * dcolor.y,
                      0.9f * e.z * weight * dcolor.z);
        dw = 0.9f * e.x * term_rgb.x * dcolor.x + 0.9f * e.y * term_rgb.y * dcolor.y +
             0.9f * e.z * term_rgb.z * dcolor.z;
      } else {
        img_acc = add(img_acc, make(ph.rgb.x * e.x, ph.rgb.y * e.y, ph.rgb.z * e.z));
        de = make(ph.rgb.x * dcolor.x, ph.rgb.y * dcolor.y, ph.rgb.z * dcolor.z);
        dp_rgb = make(e.x * dcolor.x, e.y * dcolor.y, e.z * dcolor.z);
      }
      // e = indirect + light_rgb * dl_scale
      dcam[18] += de.x, dcam[19] += de.y, dcam[20] += de.z;
      dcam[15] += de.x * dl_scale, dcam[16] += de.y * dl_scale, dcam[17] += de.z * dl_scale;
      const float ddl = dot(de, light_rgb);
      // dl_scale = lit * lam / S; lam = max(cosl, 0) / (4 pi rs)
      const float dlam = rz ? 0.0f : ddl * lit / fS;
      const float dm = dlam / den;
      const float drs = -(dlam * lam) / rs;
      const float dcosl = cosl > 0.0f ? dm : (cosl == 0.0f ? 0.5f * dm : 0.0f);
      const V3 dsdir = add(scale(dcosl, sp_nrm), scale(2.0f * drs, sdir));
      const V3 dsp_nrm = scale(dcosl, sdir);
      dcam[12] += dsdir.x, dcam[13] += dsdir.y, dcam[14] += dsdir.z;
      if (prim_diffuse) {
        dp_pos = neg(dsdir);
        dp_nrm = dsp_nrm;
      } else {
        dt_pos = neg(dsdir);
        dt_nrm = dsp_nrm;
      }
    }

    // --- reverse sweep over the chain, to the warp's deepest ray ---
    V3 dc_d = zero3(), dc_pos = zero3(), dc_nrm = zero3();
    if constexpr (Chain) {
      int k_max = n_exec;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) k_max = max(k_max, __shfl_xor_sync(kFull, k_max, off));
      for (int k = k_max - 1; k >= 0; --k) {
        RowGrad gr = zero_grad();
        int sid = -1;
        if (k < n_exec) {
          // the deep instance reads its step's 12 floats from device memory
          // into registers at the top of the step (PERF.md §6: K3b deep
          // took 5% from it; reading step k - 1 during step k gained
          // nothing); the register instance reads its own stack
          float sv_deep[kStepFloats];
          const float* sv;
          if constexpr (Deep) {
            const auto s_k = saved[k];
#pragma unroll
            for (int j = 0; j < kStepFloats; ++j) sv_deep[j] = s_k[j];
            sv = sv_deep;
          } else {
            sv = saved[k];
          }
          const int sid_k = saved_id[k];
          const V3 cur_d = make(sv[0], sv[1], sv[2]), cur_pos = make(sv[3], sv[4], sv[5]);
          const V3 cur_nrm = make(sv[6], sv[7], sv[8]);
          const float w_prev = sv[11];
          const Step s = step_geometry(P, cur_d, cur_pos, cur_nrm, sv[9], sv[10]);
          const Row row = REPLAY_LOAD_ROW(sid_k);
          const bool diffuse = row.valid && row.mat > 0.0f;
          const bool cont = row.valid && row.mat <= 0.0f;
          // which outputs of the step the later cotangents reach
          V3 dh_pos = zero3(), dh_nrm = zero3(), dh_rgb = zero3(), dndirn = zero3();
          if (diffuse) {
            dh_pos = dt_pos, dh_nrm = dt_nrm, dh_rgb = dt_rgb;
            dt_pos = dt_nrm = dt_rgb = zero3();
          }
          if (cont) {
            dndirn = dc_d, dh_pos = dc_pos, dh_nrm = dc_nrm;
            dc_d = dc_pos = dc_nrm = zero3();
          }
          V3 dnstart = zero3();
          hit_bwd(row, s.nstart, s.ndirn, dh_pos, dh_nrm, dh_rgb, gr, dnstart, dndirn);
          if (row.valid) sid = sid_k;
          // ndirn = ndir * inv, inv = max(ndir.ndir, 1e-30)^(-1/2)
          V3 dndir = scale(s.inv, dndirn);
          const float dinv = dot(dndirn, s.ndir);
          if (s.nd2raw >= 1e-30f)
            dndir = add(dndir, scale(2.0f * (-0.5f * dinv * s.inv * s.inv * s.inv), s.ndir));
          // nstart = cur_pos + bias * ndir
          dc_pos = add(dc_pos, dnstart);
          dndir = add(dndir, scale(P.bias, dnstart));
          // weight = w_prev * w_step
          float dc1a = 0.0f;
          if (P.fresnel) {
            const float dw_step = dw * w_prev;
            dw = dw * s.w_step;
            if (!s.use_refl) {
              const float x2 = s.x * s.x;
              dc1a = dw_step * (1.0f - s.r0f) * 5.0f * (x2 * x2);  // -drefl_w/dc1a * dw_step
            }
          }
          float ddn = 0.0f;
          if (s.use_refl) {
            // refl = cur_d - (2 dn) cur_nrm
            dc_d = add(dc_d, dndir);
            dc_nrm = add(dc_nrm, scale(-2.0f * s.dn, dndir));
            ddn = -2.0f * dot(dndir, cur_nrm);
          } else {
            // refr = nr cur_d + (nr c1a - c2) (-nflip)
            const float sc = s.nr * s.c1a - s.c2;
            dc_d = add(dc_d, scale(s.nr, dndir));
            const float dsc = -dot(dndir, s.nflip);
            const V3 dnflip = scale(-sc, dndir);
            dc1a += s.nr * dsc;
            if (!s.tir && !s.kz) {
              // c2 = sqrt(k), k = 1 - nr^2 (1 - c1a^2)
              const float dk = -dsc / (2.0f * s.c2);
              dc1a += dk * (s.nr * s.nr) * (2.0f * s.c1a);
            }
            dc_nrm = add(dc_nrm, s.dn < 0.0f ? neg(dnflip) : dnflip);
          }
          // c1a = |dn|
          ddn += s.dn > 0.0f ? dc1a : (s.dn < 0.0f ? -dc1a : 0.0f);
          dc_d = add(dc_d, scale(ddn, cur_nrm));
          dc_nrm = add(dc_nrm, scale(ddn, cur_d));
        }
        REPLAY_SCATTER(1 + k, a, sid, gr);
      }
    }

    // --- adjoint of the primary hit and the ray generation ---
    {
      RowGrad gr;
      V3 dstart = zero3(), dd = dc_d;
      hit_bwd(prow, cam_pos, d, add(dp_pos, dc_pos), add(dp_nrm, dc_nrm), dp_rgb, gr, dstart, dd);
      V3 ddraw = dd;
      if (!P.cpu_ref) {
        // d = draw / |draw|
        const float inv = 1.0f / dlen;
        ddraw = sub(scale(inv, dd), scale(inv * inv * inv * dot(dd, draw), draw));
      }
      if (prow.valid) {
        dcam[0] += ddraw.x * base.x, dcam[1] += ddraw.x * base.y, dcam[2] += ddraw.x * base.z;
        dcam[3] += ddraw.y * base.x, dcam[4] += ddraw.y * base.y, dcam[5] += ddraw.y * base.z;
        dcam[6] += ddraw.z * base.x, dcam[7] += ddraw.z * base.y, dcam[8] += ddraw.z * base.z;
        dcam[9] += dstart.x, dcam[10] += dstart.y, dcam[11] += dstart.z;
      }
      REPLAY_SCATTER(0, a, prow.valid ? id0 : -1, gr);
    }
