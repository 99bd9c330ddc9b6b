// The structure twin's body, included as text INSIDE each twin kernel
// (bwd_twin.cu) after its signature, as K2 includes bwd_body.cuh: K7
// itself and the split instances that vary one piece of K2's structure.
// In scope: the kernel's parameters (table, g_img, pid, lit_in, bid,
// partial, img, D, T), int NPool (the pool size) and int Var (kTwinAsK2,
// kTwinNoShfl: no warp shuffles in the scatter and the camera sums, each
// lane 0 adding its own row; kTwinNoChain: no chain storage, no forward or
// reverse sweep).
  extern __shared__ float smem[];
  const int acc_cols = D.n_obj * kGradCols + kCamCols;
  float* obj = smem;
  float* acc = obj + D.n_obj * kObjCols;  // [kWarps][acc_cols]
  for (int i = threadIdx.x; i < D.n_obj * kObjCols; i += blockDim.x) obj[i] = table[i];
  for (int i = threadIdx.x; i < kWarps * acc_cols; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  float* wacc = acc + (threadIdx.x >> 5) * acc_cols;

  const int lane = threadIdx.x & 31;
  const size_t n_pix = (size_t)D.rows * D.width;
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_img = p < n_pix;
  const float gx = in_img ? g_img[p * 3] : 0.0f;
  const int A = D.aa;

  float dcam[kCamCols];
#pragma unroll
  for (int i = 0; i < kCamCols; ++i) dcam[i] = 0.0f;
  float img_acc[3] = {0.0f, 0.0f, 0.0f};
  float saved[kRegBounces][12];
  int saved_id[kRegBounces];

  for (int a = 0; a < A; ++a) {
    const int id0 = in_img ? pid[a * n_pix + p] : -1;
    const float lit = in_img ? lit_in[a * n_pix + p] : 0.0f;
    float xs[kObjCols];
    twin_row(obj, id0, xs);
    const bool chain = id0 >= 0 && xs[15] <= 0.0f;
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

    // --- forward sweep: the steps the record says this ray ran ---
    float carr = a_mid;
    int n_exec = 0;
    bool active = chain && Var != kTwinNoChain;
    while (active && n_exec < D.bounces) {
      const int idk = bid[((size_t)n_exec * A + a) * n_pix + p];
      float row[kObjCols];
      twin_row(obj, idk, row);
      float* sv = saved[n_exec];
#pragma unroll
      for (int c = 0; c < 11; ++c) sv[c] = row[c];
      sv[11] = carr;
      saved_id[n_exec] = idk;
      ++n_exec;
      carr = carr + row[0];
      active = idk >= 0 && row[15] <= 0.0f;
    }

    // --- reverse sweep, to the warp's deepest chain ---
    float dcarr = carr;
    if constexpr (Var != kTwinNoChain) {
      int k_max = n_exec;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) k_max = max(k_max, __shfl_xor_sync(kFull, k_max, off));
      for (int k = k_max - 1; k >= 0; --k) {
        float gr[kGradCols];
#pragma unroll
        for (int c = 0; c < kGradCols; ++c) gr[c] = 0.0f;
        int sid = -1;
        if (k < n_exec) {
          const float* sv = saved[k];
          const int id = saved_id[k];
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

    // --- the primary site's scatter, the camera, the image ---
    {
      float gr[kGradCols];
#pragma unroll
      for (int c = 0; c < 15; ++c) gr[c] = accs[c % kTwinSlots];
      gr[15] = 1.0f;
      twin_scatter<Var>(wacc, id0, as_grad(gr));
    }
#pragma unroll
    for (int c = 0; c < kCamCols; ++c) dcam[c] = dcam[c] + (accs[c % kTwinSlots] + a_mid);
    float pacc = accs[0];
    if constexpr (NPool > 0) {
      TreeSum<NPool>::fold(pool);
      pacc = pacc + pool[0];
    }
    const float pe = pacc * 1e-6f;
#pragma unroll
    for (int c = 0; c < 3; ++c) img_acc[c] = img_acc[c] + (accs[c] + pe);
  }

  if (in_img) {
    const float fA = (float)A;
    img[p * 3 + 0] = img_acc[0] / fA;
    img[p * 3 + 1] = img_acc[1] / fA;
    img[p * 3 + 2] = img_acc[2] / fA;
  }

  // --- camera columns: the warp's 21 sums, as K2's (the no-shuffle
  // split: lane 0's own) ---
  if constexpr (Var != kTwinNoShfl) {
    warp_camera(wacc + D.n_obj * kGradCols, dcam);
  } else {
#pragma unroll
    for (int i = 0; i < kCamCols; ++i)
      if (lane == 0) wacc[D.n_obj * kGradCols + i] = dcam[i];
  }

  // --- the block's partial row: its warps' accumulators added in order ---
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * acc_cols;
  for (int i = threadIdx.x; i < acc_cols; i += blockDim.x) {
    float s = acc[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += acc[w * acc_cols + i];
    out[i] = s;
  }
