// Kernels K1..K4: one 60 Hz control step of the articulated-body physics,
// for a batch of independent envs, on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel steppingstone_tpu/physics/pallas_step.py
// (`build_batched_step`, the pallas_call at pallas_step.py:733) in all its
// specializations, as compile-time variants of one body,
// `control_step_kernel<PD, PLANK, ROT>`:
//   K1    <false, false, false>  torque actuation, disc support
//   K2    <false, true, false>   plank support (`support_hy`, pallas_step.py:
//                                420-431, 648-657): each stone's in-plane axes
//                                ux = normalize(h - (h.n) n), uy = n x ux once
//                                per control step, and the box bound
//                                |x_l| <= r + margin, |y_l| <= hy + margin in
//                                place of the disc bound
//   K3    <true, false, false>   stable PD (`pd=True`, pallas_step.py:474-488):
//                                every substep tau_pd = clip(kp (target - q) -
//                                kd qd, +-limit) * power on joints with kp or kd
//                                nonzero, and power kd, power kp on the
//                                implicit D, K diagonals
//   K4    <false, false, true>   rotated joint frames (`model.joint_rot`, the
//                                URDF <origin rpy>, pallas_step.py:290-305,
//                                357): the hinge frame is
//                                quat[p] * jrot[i] * axis_angle(axis[i], q_j);
//                                rows that are exactly the identity skip the
//                                product (no snapping: the Pallas kernel's
//                                snap moves values by < 1e-12, below fp32)
//   and their combinations K2+K3, K2+K4, K3+K4, K2+K3+K4.
// It computes the same function as the plain PyTorch version
// `engine._step_scan` of this package and follows that version's order of
// operations: stones are tested in order and the ground last, with the
// first maximum winning; each foot reports its strongest contact; the
// Cholesky factor uses rsqrtf(fmaxf(d, 1e-12f)) on its diagonal.
//
// Layout: one thread per env, blocks of 128 threads, a tail guard so any
// batch size works. Global arrays are struct-of-arrays with the env index
// fastest ((k, B) row-major), so each load and store of a warp is one
// coalesced 128-byte transaction; the wrapper transposes (B, k) <-> (k, B).
// The substep loop runs inside the kernel, so the state never leaves the
// thread between substeps.
//
// What bounds it: per env and control step the kernel moves ~1 KB but
// does ~10^5 fp32 operations (CRBA, RNEA, a 20-27-dof Cholesky, spheres x
// 20 stone tests, four times), so the floor is the fp32 rate, not memory.
// This first version keeps the model as runtime data in a
// __grid_constant__ struct (uniform loads served by the constant cache)
// and the per-env scratch (body frames, packed mass matrix) in local
// memory; with one thread per env, 4096 envs fill only ~1 warp per SM
// scheduler, so it is latency-bound and far from that floor. A later
// version can give each env a warp, or fold the model into the code.
// The fixed joint rotations (K4) stay out of the struct, which would pass
// the classic 4 KB kernel-parameter limit with them: they are a small
// (NB, 4) device array read with uniform __ldg loads, and a bit mask
// `rot_rows` marks the rows that are not the identity.

#include <cuda_runtime.h>
#include <math.h>

#define MAXB 32            // bodies
#define MAXJ (MAXB - 1)    // joints
#define MAXD (MAXJ + 6)    // dofs
#define MAXQ (MAXJ + 7)    // generalized coordinates
#define MAXC 16            // contact spheres
#define MAXS 32            // stones
#define TRI(i, j) ((i) * ((i) + 1) / 2 + (j))  // packed lower triangle, j <= i

// Mirrored field for field by `_ModelData` in physics/step_kernel.py.
struct ModelData {
  unsigned long long anc[MAXD];  // bit l of anc[k]: dof l is an ancestor-or-self of dof k
  int nb, nc, substeps, unused;
  int parent[MAXB];
  int cbody[MAXC];
  int cfoot[MAXC];
  float axis[MAXB][3];
  float anchor[MAXB][3];
  float com[MAXB][3];
  float inertia[MAXB][3];
  float mass[MAXB];
  float jlo[MAXJ], jhi[MAXJ], jdamp[MAXJ], jstiff[MAXJ], jref[MAXJ];
  float kp[MAXJ], kd[MAXJ], tlim[MAXJ];  // stable-PD gains, 0 where not actuated
  float coff[MAXC][3];
  float crad[MAXC];
  float kn, cn, mu, kt, margin;
  float dt, limit_k, limit_c, max_qd, gravity, reg;
};

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Hamilton product o = a * b
__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// o = R(q) v = v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ void qrot(const float* q, const float* v, float* o) {
  float uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
  for (int a = 0; a < 3; ++a) o[a] = v[a] + 2.0f * (q[0] * uv[a] + uuv[a]);
}

// spatial inertia I about the origin of a body with mass m, CoM c and
// world inertia about the CoM `iw` (sym3 xx xy xz yy yz zz), applied to
// v = [w; v_O]: h_lin = m (v_O + w x c), h_ang = I_c w + c x h_lin
__device__ __forceinline__ void inertia_mul(float m, const float* c, const float* iw,
                                            const float* v, float* o) {
  float wc[3], hl[3], ch[3];
  cross3(v, c, wc);
  for (int a = 0; a < 3; ++a) hl[a] = m * (v[3 + a] + wc[a]);
  cross3(c, hl, ch);
  o[0] = iw[0] * v[0] + iw[1] * v[1] + iw[2] * v[2] + ch[0];
  o[1] = iw[1] * v[0] + iw[3] * v[1] + iw[4] * v[2] + ch[1];
  o[2] = iw[2] * v[0] + iw[4] * v[1] + iw[5] * v[2] + ch[2];
  o[3] = hl[0];
  o[4] = hl[1];
  o[5] = hl[2];
}

// PD: stable-PD actuation toward target_in (NJ, B) scaled by power_in (B,);
// PLANK: box support with lateral bound hy_margin (= support_hy + margin);
// ROT: fixed joint rotations jrot_in (NB, 4) wxyz on the rows set in rot_rows.
template <bool PD, bool PLANK, bool ROT>
__global__ void __launch_bounds__(128)
control_step_kernel(const __grid_constant__ ModelData m, int B, int S, float hy_margin,
                    unsigned int rot_rows, const float* __restrict__ jrot_in,
                    const float* __restrict__ q_in, const float* __restrict__ qd_in,
                    const float* __restrict__ tau_in, const float* __restrict__ target_in,
                    const float* __restrict__ power_in, const float* __restrict__ st_in,
                    const float* __restrict__ sr_in, const float* __restrict__ ug_in,
                    float* __restrict__ q_out, float* __restrict__ qd_out,
                    float* __restrict__ info_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int NB = m.nb, NJ = NB - 1, ND = NB + 5, NQ = NB + 6, NC = m.nc;
  const float dt = m.dt;

  float q[MAXQ], qd[MAXD], tau_j[MAXJ];
  for (int k = 0; k < NQ; ++k) q[k] = q_in[k * B + e];
  for (int k = 0; k < ND; ++k) qd[k] = qd_in[k * B + e];
  for (int j = 0; j < NJ; ++j) tau_j[j] = tau_in[j * B + e];
  float target[PD ? MAXJ : 1];
  float power = 0.0f;
  if constexpr (PD) {
    for (int j = 0; j < NJ; ++j) target[j] = target_in[j * B + e];
    power = power_in[e];
  }

  // stone centers and top normals (and for planks the in-plane axes of the
  // top, contact.support_axes), once per control step
  float sc[MAXS][3], sn[MAXS][3];
  float su[PLANK ? MAXS : 1][3], sv[PLANK ? MAXS : 1][3];
  for (int s = 0; s < S; ++s) {
    for (int a = 0; a < 3; ++a) sc[s][a] = st_in[(s * 6 + a) * B + e];
    const float xt = st_in[(s * 6 + 4) * B + e], yt = st_in[(s * 6 + 5) * B + e];
    const float cx = cosf(xt), cy = cosf(yt);
    sn[s][0] = sinf(yt) * cx;
    sn[s][1] = -sinf(xt);
    sn[s][2] = cy * cx;
    if constexpr (PLANK) {
      const float ph = st_in[(s * 6 + 3) * B + e];
      const float h[3] = {cosf(ph), sinf(ph), 0.0f};
      const float hn = dot3(h, sn[s]);
      float ux[3];
      for (int a = 0; a < 3; ++a) ux[a] = h[a] - hn * sn[s][a];
      const float un = sqrtf(dot3(ux, ux) + 1e-12f);
      for (int a = 0; a < 3; ++a) su[s][a] = ux[a] / un;
      cross3(sn[s], su[s], sv[s]);
    }
  }
  const float rim = sr_in[e] + m.margin;
  const bool use_ground = ug_in[e] != 0.0f;

  // aggregates over substeps
  float foot_peak[2] = {0.0f, 0.0f}, foot_stone[2] = {-1.0f, -1.0f}, fsum = 0.0f;
  float at_limit[MAXJ];
  for (int j = 0; j < NJ; ++j) at_limit[j] = 0.0f;

  // per-substep scratch
  float pos[MAXB][3], quat[MAXB][4], Rm[MAXB][9], comw[MAXB][3], iw[MAXB][6];
  float vel[MAXB][6], fb[MAXB][6], acc[MAXB][6];
  float ic[MAXB][10];             // composite inertia: Ibar sym3 (6), h = m c (3), m
  float phi[MAXD][6];
  float A[MAXD * (MAXD + 1) / 2];  // packed lower triangle of the LHS, then its factor
  float rhs[MAXD], damp_eff[MAXJ], stiff_eff[MAXJ];
  float fn_c[MAXC], si_c[MAXC];

  for (int sub = 0; sub < m.substeps; ++sub) {
    // ---- forward kinematics ------------------------------------------
    for (int a = 0; a < 3; ++a) pos[0][a] = q[a];
    for (int a = 0; a < 4; ++a) quat[0][a] = q[3 + a];
    for (int i = 1; i < NB; ++i) {
      const int p = m.parent[i];
      float t[3];
      qrot(quat[p], m.anchor[i], t);
      for (int a = 0; a < 3; ++a) pos[i][a] = pos[p][a] + t[a];
      float sh, ch;
      sincosf(0.5f * q[6 + i], &sh, &ch);
      const float qa[4] = {ch, m.axis[i][0] * sh, m.axis[i][1] * sh, m.axis[i][2] * sh};
      float qp[4] = {quat[p][0], quat[p][1], quat[p][2], quat[p][3]};
      if constexpr (ROT) {
        if ((rot_rows >> i) & 1u) {  // fixed frame rotation before the hinge
          const float jr[4] = {__ldg(jrot_in + 4 * i), __ldg(jrot_in + 4 * i + 1),
                               __ldg(jrot_in + 4 * i + 2), __ldg(jrot_in + 4 * i + 3)};
          qmul(quat[p], jr, qp);
        }
      }
      qmul(qp, qa, quat[i]);
    }
    for (int i = 0; i < NB; ++i) {
      const float w = quat[i][0], x = quat[i][1], y = quat[i][2], z = quat[i][3];
      const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
      const float wx = w * x, wy = w * y, wz = w * z;
      float* R = Rm[i];
      R[0] = 1 - 2 * (yy + zz); R[1] = 2 * (xy - wz);     R[2] = 2 * (xz + wy);
      R[3] = 2 * (xy + wz);     R[4] = 1 - 2 * (xx + zz); R[5] = 2 * (yz - wx);
      R[6] = 2 * (xz - wy);     R[7] = 2 * (yz + wx);     R[8] = 1 - 2 * (xx + yy);
      for (int a = 0; a < 3; ++a)
        comw[i][a] = pos[i][a] + (R[3 * a] * m.com[i][0] + R[3 * a + 1] * m.com[i][1] +
                                  R[3 * a + 2] * m.com[i][2]);
      // R diag(I) R^T
      int t = 0;
      for (int a = 0; a < 3; ++a)
        for (int b = a; b < 3; ++b)
          iw[i][t++] = R[3 * a] * m.inertia[i][0] * R[3 * b] +
                       R[3 * a + 1] * m.inertia[i][1] * R[3 * b + 1] +
                       R[3 * a + 2] * m.inertia[i][2] * R[3 * b + 2];
    }
    const float root[3] = {pos[0][0], pos[0][1], pos[0][2]};

    // ---- motion axes and body velocities -------------------------------
    for (int k = 0; k < 6; ++k)
      for (int a = 0; a < 6; ++a) phi[k][a] = (a == k) ? 1.0f : 0.0f;
    for (int a = 0; a < 6; ++a) vel[0][a] = qd[a];
    for (int i = 1; i < NB; ++i) {
      float* ph = phi[5 + i];
      qrot(quat[i], m.axis[i], ph);  // world joint axis
      const float prel[3] = {pos[i][0] - root[0], pos[i][1] - root[1], pos[i][2] - root[2]};
      cross3(prel, ph, ph + 3);
      const int p = m.parent[i];
      for (int a = 0; a < 6; ++a) vel[i][a] = vel[p][a] + ph[a] * qd[5 + i];
    }

    // ---- contacts ---------------------------------------------------------
    for (int i = 0; i < NB; ++i)
      for (int a = 0; a < 6; ++a) fb[i][a] = 0.0f;
    float fsum_sub = 0.0f;
    for (int c = 0; c < NC; ++c) {
      const int b = m.cbody[c];
      const float* R = Rm[b];
      float pt[3], rel_root[3], wr[3], pv[3];
      for (int a = 0; a < 3; ++a)
        pt[a] = pos[b][a] + (R[3 * a] * m.coff[c][0] + R[3 * a + 1] * m.coff[c][1] +
                             R[3 * a + 2] * m.coff[c][2]);
      for (int a = 0; a < 3; ++a) rel_root[a] = pt[a] - root[a];
      cross3(vel[b], rel_root, wr);
      for (int a = 0; a < 3; ++a) pv[a] = vel[b][3 + a] + wr[a];
      const float rad = m.crad[c];

      // deepest valid support: stones in order, then the ground
      float best = -INFINITY;
      int bi = 0;
      for (int s = 0; s < S; ++s) {
        float rel[3], lat[3];
        for (int a = 0; a < 3; ++a) rel[a] = pt[a] - sc[s][a];
        const float dn = dot3(rel, sn[s]);
        for (int a = 0; a < 3; ++a) lat[a] = rel[a] - dn * sn[s][a];
        const float pen = rad - dn;
        bool on_top;
        if constexpr (PLANK)
          on_top = (fabsf(dot3(lat, su[s])) <= rim) && (fabsf(dot3(lat, sv[s])) <= hy_margin);
        else
          on_top = sqrtf(dot3(lat, lat)) <= rim;
        const bool ok = on_top && (pen > 0.0f) && (dn > -rad);
        if (ok && pen > best) { best = pen; bi = s; }
      }
      const float gpen = rad - pt[2];
      if (use_ground && gpen > 0.0f && gpen > best) { best = gpen; bi = S; }
      const bool in_c = best > 0.0f;
      float n[3] = {0.0f, 0.0f, 1.0f};
      if (bi < S) for (int a = 0; a < 3; ++a) n[a] = sn[bi][a];

      const float pen_c = fmaxf(best, 0.0f);
      const float vn = dot3(pv, n);
      float fn = m.kn * pen_c - m.cn * vn * (pen_c > 0.0f ? 1.0f : 0.0f);
      fn = fmaxf(fn, 0.0f) * (in_c ? 1.0f : 0.0f);
      float vt[3];
      for (int a = 0; a < 3; ++a) vt[a] = pv[a] - vn * n[a];
      const float vtn = sqrtf(dot3(vt, vt) + 1e-8f);
      const float ftm = fminf(m.mu * fn, m.kt * vtn);
      float force[3], torque[3];
      for (int a = 0; a < 3; ++a) force[a] = fn * n[a] + (-ftm * vt[a]) / vtn;
      cross3(rel_root, force, torque);
      for (int a = 0; a < 3; ++a) {
        fb[b][a] += torque[a];
        fb[b][3 + a] += force[a];
      }
      fn_c[c] = fn;
      si_c[c] = (in_c && bi < S) ? (float)bi : -1.0f;
      fsum_sub += fn;
    }

    // ---- joint torques (actuation + passive + limits) ---------------------
    for (int k = 0; k < 6; ++k) rhs[k] = 0.0f;
    for (int j = 0; j < NJ; ++j) {
      const float qj = q[7 + j], qdj = qd[6 + j];
      const float below = fminf(qj - m.jlo[j], 0.0f);
      const float above = fmaxf(qj - m.jhi[j], 0.0f);
      const float out = (below < 0.0f || above > 0.0f) ? 1.0f : 0.0f;
      const float tau_lim = -m.limit_k * (below + above) - m.limit_c * qdj * out;
      const float passive = -m.jdamp[j] * qdj - m.jstiff[j] * (qj - m.jref[j]);
      float act = tau_j[j];
      float damp = m.jdamp[j] + m.limit_c * out;
      float stiff = m.jstiff[j] + m.limit_k * out;
      if constexpr (PD) {
        if (m.kp[j] != 0.0f || m.kd[j] != 0.0f) {
          // stable PD: explicit torque from the current substep state, the
          // gains on the implicit diagonals
          const float tpd = fminf(fmaxf(m.kp[j] * (target[j] - qj) - m.kd[j] * qdj, -m.tlim[j]),
                                  m.tlim[j]);
          act = act + power * tpd;
          damp = damp + power * m.kd[j];
          stiff = stiff + power * m.kp[j];
        }
      }
      rhs[6 + j] = act + passive + tau_lim;  // tau_full; C is subtracted below
      damp_eff[j] = damp;
      stiff_eff[j] = stiff;
      at_limit[j] = out;
    }

    // ---- CRBA: composite inertias and the ancestor-masked mass matrix -----
    for (int i = 0; i < NB; ++i) {
      const float mi = m.mass[i];
      const float c[3] = {comw[i][0] - root[0], comw[i][1] - root[1], comw[i][2] - root[2]};
      // Ibar = I_c - m [c]x [c]x = I_c + m (|c|^2 1 - c c^T)
      const float c2 = dot3(c, c);
      ic[i][0] = iw[i][0] + mi * (c2 - c[0] * c[0]);
      ic[i][1] = iw[i][1] - mi * c[0] * c[1];
      ic[i][2] = iw[i][2] - mi * c[0] * c[2];
      ic[i][3] = iw[i][3] + mi * (c2 - c[1] * c[1]);
      ic[i][4] = iw[i][4] - mi * c[1] * c[2];
      ic[i][5] = iw[i][5] + mi * (c2 - c[2] * c[2]);
      for (int a = 0; a < 3; ++a) ic[i][6 + a] = mi * c[a];
      ic[i][9] = mi;
    }
    for (int i = NB - 1; i > 0; --i) {
      const int p = m.parent[i];
      for (int a = 0; a < 10; ++a) ic[p][a] += ic[i][a];
    }
    for (int k = 0; k < ND; ++k) {
      // F = Ic phi_k = [Ibar w + h x v ; m v - h x w]
      const float* I = ic[k < 6 ? 0 : k - 5];
      const float* w = phi[k];
      const float* v = phi[k] + 3;
      float hv[3], hw[3], F[6];
      cross3(I + 6, v, hv);
      cross3(I + 6, w, hw);
      F[0] = I[0] * w[0] + I[1] * w[1] + I[2] * w[2] + hv[0];
      F[1] = I[1] * w[0] + I[3] * w[1] + I[4] * w[2] + hv[1];
      F[2] = I[2] * w[0] + I[4] * w[1] + I[5] * w[2] + hv[2];
      for (int a = 0; a < 3; ++a) F[3 + a] = I[9] * v[a] - hw[a];
      const unsigned long long anc = m.anc[k];
      for (int l = 0; l <= k; ++l) {
        float s = 0.0f;
        if ((anc >> l) & 1ull)
          for (int a = 0; a < 6; ++a) s += F[a] * phi[l][a];
        A[TRI(k, l)] = s;
      }
    }

    // ---- RNEA bias forces (qdd = 0, gravity as base acceleration) ---------
    for (int a = 0; a < 6; ++a) acc[0][a] = 0.0f;
    acc[0][5] = m.gravity;
    for (int i = 1; i < NB; ++i) {
      const int p = m.parent[i];
      float jv[6], t0[3], t1[3], t2[3];
      for (int a = 0; a < 6; ++a) jv[a] = vel[i][a] - vel[p][a];
      cross3(vel[i], jv, t0);          // w_v x w_m
      cross3(vel[i], jv + 3, t1);      // w_v x v_m
      cross3(vel[i] + 3, jv, t2);      // v_v x w_m
      for (int a = 0; a < 3; ++a) {
        acc[i][a] = acc[p][a] + t0[a];
        acc[i][3 + a] = acc[p][3 + a] + (t1[a] + t2[a]);
      }
    }
    for (int i = 0; i < NB; ++i) {
      const float c[3] = {comw[i][0] - root[0], comw[i][1] - root[1], comw[i][2] - root[2]};
      float Iv[6], Ia[6], t0[3], t1[3], t2[3];
      inertia_mul(m.mass[i], c, iw[i], vel[i], Iv);
      inertia_mul(m.mass[i], c, iw[i], acc[i], Ia);
      cross3(vel[i], Iv, t0);          // w x n
      cross3(vel[i] + 3, Iv + 3, t1);  // v x f
      cross3(vel[i], Iv + 3, t2);      // w x f
      for (int a = 0; a < 3; ++a) {
        fb[i][a] = (Ia[a] + (t0[a] + t1[a])) - fb[i][a];
        fb[i][3 + a] = (Ia[3 + a] + t2[a]) - fb[i][3 + a];
      }
    }
    for (int i = NB - 1; i > 0; --i) {
      const int p = m.parent[i];
      for (int a = 0; a < 6; ++a) fb[p][a] += fb[i][a];
    }
    for (int k = 0; k < 6; ++k) rhs[k] -= fb[0][k];
    for (int i = 1; i < NB; ++i) {
      float s = 0.0f;
      for (int a = 0; a < 6; ++a) s += phi[5 + i][a] * fb[i][a];
      rhs[5 + i] -= s;
    }

    // ---- implicit diagonal: reg + dt D + dt^2 K ---------------------------
    for (int k = 0; k < 6; ++k) A[TRI(k, k)] += m.reg;
    for (int j = 0; j < NJ; ++j)
      A[TRI(6 + j, 6 + j)] += (m.reg + dt * damp_eff[j]) + (dt * dt) * stiff_eff[j];

    // ---- Cholesky (right-looking, in place) and the two solves ------------
    for (int j = 0; j < ND; ++j) {
      const float d = rsqrtf(fmaxf(A[TRI(j, j)], 1e-12f));
      for (int i = j; i < ND; ++i) A[TRI(i, j)] *= d;
      for (int k = j + 1; k < ND; ++k) {
        const float lkj = A[TRI(k, j)];
        for (int i = k; i < ND; ++i) A[TRI(i, k)] -= A[TRI(i, j)] * lkj;
      }
    }
    for (int j = 0; j < ND; ++j) {  // L y = rhs (rhs becomes y)
      rhs[j] /= A[TRI(j, j)];
      for (int i = j + 1; i < ND; ++i) rhs[i] -= A[TRI(i, j)] * rhs[j];
    }
    for (int j = ND - 1; j >= 0; --j) {  // L^T x = y (rhs becomes qdd)
      float s = 0.0f;
      for (int k = j + 1; k < ND; ++k) s += A[TRI(k, j)] * rhs[k];
      rhs[j] = (rhs[j] - s) / A[TRI(j, j)];
    }

    // ---- semi-implicit Euler -----------------------------------------------
    float qdn[MAXD];
    for (int k = 0; k < ND; ++k) qdn[k] = fminf(fmaxf(qd[k] + dt * rhs[k], -m.max_qd), m.max_qd);
    const float omega_q[4] = {0.0f, qdn[0], qdn[1], qdn[2]};
    float root_new[3], dr[3], wdr[3], dq[4], qu[4];
    for (int a = 0; a < 3; ++a) root_new[a] = root[a] + dt * qdn[3 + a];
    for (int a = 0; a < 3; ++a) dr[a] = root_new[a] - root[a];
    cross3(qdn, dr, wdr);
    qmul(omega_q, q + 3, dq);
    for (int a = 0; a < 4; ++a) qu[a] = q[3 + a] + dt * (0.5f * dq[a]);
    const float qn = sqrtf(qu[0] * qu[0] + qu[1] * qu[1] + qu[2] * qu[2] + qu[3] * qu[3] + 1e-12f);
    for (int a = 0; a < 3; ++a) q[a] = root_new[a];
    for (int a = 0; a < 4; ++a) q[3 + a] = qu[a] / qn;
    for (int j = 0; j < NJ; ++j) q[7 + j] += dt * qdn[6 + j];
    for (int a = 0; a < 3; ++a) qd[a] = qdn[a];
    for (int a = 0; a < 3; ++a) qd[3 + a] = qdn[3 + a] + wdr[a];
    for (int k = 6; k < ND; ++k) qd[k] = qdn[k];

    // ---- per-foot diagnostics: each foot's strongest contact ----------------
    for (int foot = 0; foot < 2; ++foot) {
      float f = 0.0f, bp = -1.0f, si = -1.0f;
      for (int c = 0; c < NC; ++c) {
        if (m.cfoot[c] != foot) continue;
        f = fmaxf(f, fn_c[c]);
        if (fn_c[c] > bp) { bp = fn_c[c]; si = si_c[c]; }
      }
      const float s = f > 0.0f ? si : -1.0f;
      foot_peak[foot] = fmaxf(foot_peak[foot], f);
      if (s >= 0.0f) foot_stone[foot] = s;
    }
    fsum += fsum_sub;
  }

  for (int k = 0; k < NQ; ++k) q_out[k * B + e] = q[k];
  for (int k = 0; k < ND; ++k) qd_out[k * B + e] = qd[k];
  // info rows: foot force x2, foot stone x2, foot peak force x2, at_limit x NJ, force sum
  info_out[0 * B + e] = foot_peak[0];
  info_out[1 * B + e] = foot_peak[1];
  info_out[2 * B + e] = foot_stone[0];
  info_out[3 * B + e] = foot_stone[1];
  info_out[4 * B + e] = foot_peak[0];
  info_out[5 * B + e] = foot_peak[1];
  for (int j = 0; j < NJ; ++j) info_out[(6 + j) * B + e] = at_limit[j];
  info_out[(6 + NJ) * B + e] = fsum;
}

template <bool PD, bool PLANK, bool ROT>
static void launch(const ModelData* model, int B, int S, float hy_margin, unsigned int rot_rows,
                   const float* jrot, const float* q, const float* qd, const float* tau,
                   const float* target, const float* power, const float* stones,
                   const float* stone_radius, const float* use_ground, float* q_out,
                   float* qd_out, float* info_out, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  control_step_kernel<PD, PLANK, ROT><<<blocks, threads, 0, stream>>>(
      *model, B, S, hy_margin, rot_rows, jrot, q, qd, tau, target, power, stones, stone_radius,
      use_ground, q_out, qd_out, info_out);
}

extern "C" {

// sizeof(ModelData), so the binding can check that its mirror matches
int control_step_model_size(void) { return (int)sizeof(ModelData); }

// Launch the (pd, plank, rot) variant on `stream`; target and power are
// read only when pd != 0, hy_margin only when plank != 0, rot_rows and
// jrot (NB, 4) only when rot != 0. Returns cudaGetLastError() (0 = launched).
int control_step_launch(const ModelData* model, int B, int S, int pd, int plank, int rot,
                        float hy_margin, unsigned int rot_rows, const float* jrot,
                        const float* q, const float* qd, const float* tau, const float* target,
                        const float* power, const float* stones, const float* stone_radius,
                        const float* use_ground, float* q_out, float* qd_out, float* info_out,
                        void* stream) {
#define CONTROL_STEP_ARGS                                                                    \
  model, B, S, hy_margin, rot_rows, jrot, q, qd, tau, target, power, stones, stone_radius, \
      use_ground, q_out, qd_out, info_out, (cudaStream_t)stream
  switch ((pd ? 4 : 0) | (plank ? 2 : 0) | (rot ? 1 : 0)) {
    case 0: launch<false, false, false>(CONTROL_STEP_ARGS); break;
    case 1: launch<false, false, true>(CONTROL_STEP_ARGS); break;
    case 2: launch<false, true, false>(CONTROL_STEP_ARGS); break;
    case 3: launch<false, true, true>(CONTROL_STEP_ARGS); break;
    case 4: launch<true, false, false>(CONTROL_STEP_ARGS); break;
    case 5: launch<true, false, true>(CONTROL_STEP_ARGS); break;
    case 6: launch<true, true, false>(CONTROL_STEP_ARGS); break;
    default: launch<true, true, true>(CONTROL_STEP_ARGS); break;
  }
#undef CONTROL_STEP_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
