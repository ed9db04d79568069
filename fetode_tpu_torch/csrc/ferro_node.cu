// Whole-solve kernels of the ECG ferro MLP-NODE latent field for Hopper
// (sm_90a): the forward dopri5 solve over [0, 1] (with or without
// per-attempt records) and the reverse replay, the discrete adjoint on
// the recorded step mesh, with optional frozen device noise.
//
// Replaces the TPU kernel fetode_tpu/ops/pallas_ferro_node.py:416
// (make_ferro_node_solver: forward _make_fwd_kernel :87, backward
// _make_bwd_kernel :150; the batch-vectorized pair :259 / :309 is another
// TPU layout of the same function and maps to these kernels too).  The
// field, D -> H -> D with two ferro layers whose parameters are (out, L),
// L = in*K, l = i*K + k:
//
//   hb = h_bound tanh(y / h_bound)
//   z  = tanh(sum_l fb1[b, o, l] coef1[o, l])          (B, H)
//   dh = clip(sum_l fb2[b, o, l] coef2[o, l], -c, c)    (B, D)
//
// with the ferro term of the fresh frozen state (_ferro_rows :70):
// mu = sigmoid(g x), cn = sigmoid(g (-x - ec)), beta = alpha + (1 - alpha)
// (1 - 2 (1 - mu) cn), th = tanh(k (x + ec beta)), fb = ps th + bias
// (+ the frozen noise nz[b, o, l] when noisy, which reaches only the coef
// gradient).  Unlike the eager model field there is no nan_to_num, and the
// clip passes the gradient strictly inside (-c, c), as in the TPU kernel.
//
// Field evaluation, two grid phases: layer 1 then layer 2, one warp per
// output (b, o), lanes striding over l, a fixed shuffle tree.  A warp
// first puts its sample's input row and sigmoid(g x) (which depends on
// the input only) into shared memory.
// VJP, six phases: the two forward phases again (layer 2 forms the
// masked output cotangent), then per layer the backward: each thread owns
// parameter elements (o, l), sums their five gradients over the batch in
// registers and adds them to the gradient arrays in a fixed order, and
// stages the input cotangent of every (b, o, l); one warp per (b, i) then
// sums its staged values over (o, k) and applies the tanh link (layer 2
// to layer 1) or the bound chain (layer 1 to the state).  No atomics: the
// gradients are the same bits on every run.
//
// What bounds it on this card: transcendental arithmetic.  At the ECG
// widths (D = 64, H = 128, K = 12, B = 8) one evaluation is 2 x 8 x 98,304
// ferro terms, each a sigmoid (an expf and a division) and a tanhf, about
// 40 instructions without --use_fast_math; a VJP evaluates the terms
// twice.  The parameters (10 x 98,304 floats, 3.9 MB) stay in L2.  The
// design spreads the terms over every SM of a cooperative grid and keeps
// the per-input sigmoid out of the per-term work; at B = 8 each phase
// leaves many SMs idle between barriers, so the serial chain of grid
// barriers (about 3 per evaluation, 7 per VJP) is the other bound.

#include "node_common.cuh"

namespace {

using namespace node_common;

constexpr int kMaxRow = 512;  // the latent and hidden widths, at most

// One warp's two shared-memory rows of kMaxRow floats.
__device__ __forceinline__ float* warp_rows() {
  __shared__ float rows[kWarps][2 * kMaxRow];
  return rows[threadIdx.x >> 5];
}

struct FerroLayer {
  const float* fk;  // (out, L) each
  const float* fec;
  const float* fps;
  const float* fbias;
  const float* fcoef;
  const float* nz;  // (B, out, L) frozen noise, or null
  float* gk;        // (out, L) gradients, VJP only
  float* gec;
  float* gps;
  float* gbias;
  float* gcoef;
  int out, K, L;
};

struct Term {
  float cn, beta, th, fb;
};

struct FerroField {
  FerroLayer l1, l2;
  int B, D, H;
  float gate, alpha, oma, c2;  // c2 = 2 gate (1 - alpha)
  float h_bound, inv_hb, dh_clip;
  float* hb;    // (B, D) bounded state
  float* mu1;   // (B, D) sigmoid(gate hb)
  float* z;     // (B, H) hidden activation
  float* mu2;   // (B, H) sigmoid(gate z)
  float* wcol;  // (B, max(D, H)) a layer's output cotangent
  float* xfb;   // (B, out, L) a layer's staged input cotangents

  __device__ __forceinline__ Term term(const FerroLayer& p, int e, float x,
                                       float mu) const {
    Term r;
    const float ec = p.fec[e];
    r.cn = sigmoid(gate * (-x - ec));
    r.beta = alpha + oma * (1.0f - 2.0f * ((1.0f - mu) * r.cn));
    r.th = tanhf(p.fk[e] * (x + ec * r.beta));
    r.fb = p.fps[e] * r.th + p.fbias[e];
    return r;
  }

  // sum_l fb[b, o, l] coef[o, l] by one warp; x, mu: the input row.
  __device__ float row_sum(const FerroLayer& p, const float* x,
                           const float* mu, int b, int o) const {
    const float* nz = p.nz ? p.nz + ((size_t)b * p.out + o) * p.L : nullptr;
    float acc = 0.0f;
    for (int l = lane_id(); l < p.L; l += 32) {
      const int e = o * p.L + l, i = l / p.K;
      float fb = term(p, e, x[i], mu[i]).fb;
      if (nz) fb += nz[l];
      acc += fb * p.fcoef[e];
    }
    return warp_sum(acc);
  }

  // Layer 1: z = tanh(ferro1(hb)); also hb and mu1 for the VJP.
  __device__ void layer1(const float* u) const {
    float* xs = warp_rows();
    float* ms = xs + kMaxRow;
    const int lane = lane_id();
    for (int w = grid_warp(); w < B * H; w += grid_warps()) {
      const int b = w / H, o = w - b * H;
      for (int i = lane; i < D; i += 32) {
        const float h = h_bound * tanhf(ld(u + b * D + i) * inv_hb);
        xs[i] = h;
        ms[i] = sigmoid(gate * h);
        if (o == 0) {
          hb[b * D + i] = h;
          mu1[b * D + i] = ms[i];
        }
      }
      __syncwarp();
      const float s = row_sum(l1, xs, ms, b, o);
      if (lane == 0) z[w] = tanhf(s);
      __syncwarp();
    }
  }

  // Layer 2 on z: with w null, out = clip(dh); else out = w where
  // -c < dh < c and 0 elsewhere (the clip's strict mask); also mu2.
  __device__ void layer2(float* out, const float* w) const {
    float* xs = warp_rows();
    float* ms = xs + kMaxRow;
    const int lane = lane_id();
    for (int t = grid_warp(); t < B * D; t += grid_warps()) {
      const int b = t / D, o = t - b * D;
      for (int i = lane; i < H; i += 32) {
        const float x = ld(z + b * H + i);
        xs[i] = x;
        ms[i] = sigmoid(gate * x);
        if (o == 0) mu2[b * H + i] = ms[i];
      }
      __syncwarp();
      const float dh = row_sum(l2, xs, ms, b, o);
      if (lane == 0) {
        if (w == nullptr)
          out[t] = fminf(fmaxf(dh, -dh_clip), dh_clip);
        else
          out[t] = (dh > -dh_clip && dh < dh_clip) ? ld(w + t) : 0.0f;
      }
      __syncwarp();
    }
  }

  // One layer's backward for output cotangent wc (B, out) at input x
  // (B, in) with mu = sigmoid(gate x): the five gradients of every owned
  // (o, l), and xfb[b, o, l], the cotangent of the term's input.
  __device__ void layer_bwd(const FerroLayer& p, int in, const float* x,
                            const float* mu, const float* wc) const {
    const int nth = grid_threads();
    for (int e = grid_tid(); e < p.out * p.L; e += nth) {
      const int o = e / p.L, l = e - o * p.L, i = l / p.K;
      const float k = p.fk[e], ec = p.fec[e], ps = p.fps[e], coef = p.fcoef[e];
      float gk = 0.0f, gec = 0.0f, gps = 0.0f, gbias = 0.0f, gcoef = 0.0f;
      for (int b = 0; b < B; ++b) {
        const float xv = ld(x + b * in + i), m = ld(mu + b * in + i);
        const float wv = ld(wc + b * p.out + o);
        const Term t = term(p, e, xv, m);
        const size_t s = ((size_t)b * p.out + o) * p.L + l;
        const float fb = p.nz ? t.fb + p.nz[s] : t.fb;
        gcoef += fb * wv;
        const float fbar = coef * wv;
        const float sech2 = 1.0f - t.th * t.th;
        gps += t.th * fbar;
        gbias += fbar;
        gk += ps * (xv + ec * t.beta) * sech2 * fbar;
        const float common = ps * k * sech2 * fbar;
        const float dbeta_dec = c2 * (1.0f - m) * t.cn * (1.0f - t.cn);
        const float dbeta_dx = c2 * (1.0f - m) * t.cn * (m + 1.0f - t.cn);
        gec += common * (t.beta + ec * dbeta_dec);
        xfb[s] = common * (1.0f + ec * dbeta_dx);
      }
      p.gk[e] += gk;
      p.gec[e] += gec;
      p.gps[e] += gps;
      p.gbias[e] += gbias;
      p.gcoef[e] += gcoef;
    }
  }

  // dst[b, j] = link(b, j) * sum_{o, k} xfb[b, o, j*K + k], one warp per
  // (b, j): the tanh link 1 - z^2 into layer 1's output, or the bound
  // chain 1 - (hb / h_bound)^2 into the state.
  __device__ void contract(const FerroLayer& p, int in, bool to_state,
                           float* dst) const {
    const int lane = lane_id(), n = p.out * p.K;
    for (int w = grid_warp(); w < B * in; w += grid_warps()) {
      const int b = w / in, j = w - b * in;
      const float* base = xfb + (size_t)b * p.out * p.L + j * p.K;
      float s = 0.0f;
      for (int q = lane; q < n; q += 32) {
        const int o = q / p.K, k = q - o * p.K;
        s += ld(base + (size_t)o * p.L + k);
      }
      s = warp_sum(s);
      if (lane == 0) {
        const float v = to_state ? ld(hb + w) * inv_hb : ld(z + w);
        dst[w] = s * (1.0f - v * v);
      }
    }
  }

  __device__ void eval(const float* u, float* out) const {
    layer1(u);
    cg::this_grid().sync();
    layer2(out, nullptr);
  }

  __device__ void vjp(const float* u, const float* w, float* ubar) const {
    cg::grid_group grid = cg::this_grid();
    layer1(u);
    grid.sync();
    layer2(wcol, w);
    grid.sync();
    layer_bwd(l2, H, z, mu2, wcol);
    grid.sync();
    contract(l2, H, false, wcol);
    grid.sync();
    layer_bwd(l1, D, hb, mu1, wcol);
    grid.sync();
    contract(l1, D, true, ubar);
  }
};

struct FwdArgs {
  FerroField f;
  SolveBufs s;
};

struct BwdArgs {
  FerroField f;
  ReplayBufs r;
};

template <bool kRecord>
__global__ void __launch_bounds__(kThreads) ferro_node_fwd_kernel(FwdArgs a) {
  adaptive_solve_final<kRecord>(a.f, a.s);
}

__device__ void zero_grads(const FerroLayer& p) {
  for (int e = grid_tid(); e < p.out * p.L; e += grid_threads())
    p.gk[e] = p.gec[e] = p.gps[e] = p.gbias[e] = p.gcoef[e] = 0.0f;
}

__global__ void __launch_bounds__(kThreads) ferro_node_bwd_kernel(BwdArgs a) {
  zero_grads(a.f.l1);
  zero_grads(a.f.l2);
  cg::this_grid().sync();
  adjoint_replay(a.f, a.r);
}

// Scratch layout in `work` (floats), N = B*D: the scaffold's 10N; hb, mu1
// (2N); z, mu2 (2*B*H); part; then, for the backward only, wcol
// (B*max(D, H)) and xfb (B*max(H*L1, D*L2)).
size_t work_floats(int B, int D, int H, int K1, int K2, bool bwd) {
  const size_t N = (size_t)B * D, BH = (size_t)B * H;
  size_t n = 12 * N + 2 * BH + kPartFloats;
  if (bwd) {
    const size_t wide = (size_t)(D > H ? D : H);
    const size_t s1 = (size_t)H * D * K1, s2 = (size_t)D * H * K2;
    n += B * wide + B * (s1 > s2 ? s1 : s2);
  }
  return n;
}

FerroLayer make_layer(const float* prm, const float* nz, float* grads,
                      int out, int in, int K) {
  FerroLayer p{};
  const size_t n = (size_t)out * in * K;
  p.fk = prm;
  p.fec = prm + n;
  p.fps = prm + 2 * n;
  p.fbias = prm + 3 * n;
  p.fcoef = prm + 4 * n;
  p.nz = nz;
  if (grads != nullptr) {
    p.gk = grads;
    p.gec = grads + n;
    p.gps = grads + 2 * n;
    p.gbias = grads + 3 * n;
    p.gcoef = grads + 4 * n;
  }
  p.out = out;
  p.K = K;
  p.L = in * K;
  return p;
}

FerroField make_field(const float* prm1, const float* prm2, const float* nz1,
                      const float* nz2, float* g1, float* g2, float* work,
                      int B, int D, int H, int K1, int K2, float gate,
                      float alpha, float oma, float c2, float h_bound,
                      float dh_clip) {
  FerroField f{};
  f.l1 = make_layer(prm1, nz1, g1, H, D, K1);
  f.l2 = make_layer(prm2, nz2, g2, D, H, K2);
  f.B = B;
  f.D = D;
  f.H = H;
  f.gate = gate;
  f.alpha = alpha;
  f.oma = oma;
  f.c2 = c2;
  f.h_bound = h_bound;
  f.inv_hb = 1.0f / h_bound;
  f.dh_clip = dh_clip;
  const size_t N = (size_t)B * D, BH = (size_t)B * H;
  f.hb = work + 10 * N;
  f.mu1 = f.hb + N;
  f.z = f.mu1 + N;
  f.mu2 = f.z + BH;
  f.wcol = f.mu2 + BH + kPartFloats;
  f.xfb = f.wcol + (size_t)B * (D > H ? D : H);
  return f;
}

float* part_of(float* work, int B, int D, int H) {
  return work + 12 * (size_t)B * D + 2 * (size_t)B * H;
}

}  // namespace

extern "C" long long ferro_node_work_floats(int B, int D, int H, int K1,
                                            int K2, int bwd) {
  return (long long)work_floats(B, D, H, K1, K2, bwd != 0);
}

// h0 (B, D); prm1 (5, H, D*K1) and prm2 (5, D, H*K2), the arrays k, ec,
// ps, bias, coef of each layer; nz1 (B, H, D*K1) and nz2 (B, D, H*K2), or
// null -> out (B, D) and, when record is nonzero, tda (M, 4), yrec
// (M, B, D), krec (M, 7, B, D), misc (4).
extern "C" int ferro_node_fwd(const float* h0, const float* prm1,
                              const float* prm2, const float* nz1,
                              const float* nz2, float* out, float* tda,
                              float* yrec, float* krec, float* misc,
                              float* work, int B, int D, int H, int K1, int K2,
                              int max_steps, float rtol, float atol,
                              float gate, float alpha, float oma, float c2,
                              float h_bound, float dh_clip, int record,
                              void* stream) {
  if (B <= 0) return 0;
  if (D > kMaxRow || H > kMaxRow) return (int)cudaErrorInvalidValue;
  FwdArgs a{};
  a.f = make_field(prm1, prm2, nz1, nz2, nullptr, nullptr, work, B, D, H, K1,
                   K2, gate, alpha, oma, c2, h_bound, dh_clip);
  const size_t N = (size_t)B * D;
  a.s.h0 = h0;
  a.s.out = out;
  a.s.tda = tda;
  a.s.yrec = yrec;
  a.s.krec = krec;
  a.s.misc = misc;
  a.s.y = work;
  a.s.ks = work + N;
  a.s.u = work + 8 * N;
  a.s.part = part_of(work, B, D, H);
  a.s.N = (int)N;
  a.s.max_steps = max_steps;
  a.s.rtol = rtol;
  a.s.atol = atol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return record ? launch_cooperative(ferro_node_fwd_kernel<true>, a, s)
                : launch_cooperative(ferro_node_fwd_kernel<false>, a, s);
}

// hbar (B, D) and the forward's records -> g1 (5, H, D*K1), g2
// (5, D, H*K2), h0bar (B, D).
extern "C" int ferro_node_bwd(const float* hbar, const float* tda,
                              const float* yrec, const float* krec,
                              const float* misc, const float* prm1,
                              const float* prm2, const float* nz1,
                              const float* nz2, float* g1, float* g2,
                              float* h0bar, float* work, int B, int D, int H,
                              int K1, int K2, float gate, float alpha,
                              float oma, float c2, float h_bound,
                              float dh_clip, void* stream) {
  if (B <= 0) return 0;
  if (D > kMaxRow || H > kMaxRow) return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.f = make_field(prm1, prm2, nz1, nz2, g1, g2, work, B, D, H, K1, K2, gate,
                   alpha, oma, c2, h_bound, dh_clip);
  const size_t N = (size_t)B * D;
  a.r.hbar = hbar;
  a.r.tda = tda;
  a.r.yrec = yrec;
  a.r.krec = krec;
  a.r.misc = misc;
  a.r.h0bar = h0bar;
  a.r.lam = work;
  a.r.kbar = work + N;
  a.r.u = work + 8 * N;
  a.r.ub = work + 9 * N;
  a.r.N = (int)N;
  return launch_cooperative(ferro_node_bwd_kernel, a,
                            static_cast<cudaStream_t>(stream));
}
