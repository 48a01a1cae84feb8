// Kernels K1..K4: one 60 Hz control step of the articulated-body physics,
// for a batch of independent envs, on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel steppingstone_tpu/physics/pallas_step.py
// (`build_batched_step`, the pallas_call at pallas_step.py:733) in all its
// specializations. Every variant runs `control_step_warp<PD, PLANK, ROT>`
// (a warp per env, below); the flags name them:
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
// Global arrays are struct-of-arrays with the env index fastest ((k, B)
// row-major); the wrapper transposes (B, k) <-> (k, B). The substep loop
// runs inside the kernel, so the state never leaves the chip's fast
// memory between substeps.
//
// What bounds it: per env and control step the kernel moves ~1 KB but
// does ~10^5 fp32 operations (CRBA, RNEA, a 20-27-dof Cholesky, spheres x
// 20 stone tests, four times), so the floor is the fp32 rate, not memory
// (`control_step_flops` in physics/step_kernel.py counts them).
//
// The model is runtime data in a __grid_constant__ struct (uniform loads
// served by the constant cache). The fixed joint rotations (K4) stay out of
// the struct, which would pass the classic 4 KB kernel-parameter limit with
// them: they are a small (NB, 4) device array read with __ldg loads, and a
// bit mask `rot_rows` marks the rows that are not the identity.
//
// Beside them, `foot_positions` (a thread per env and foot) computes the
// feet's world positions that the env reads after each reset and step; it
// shares the model's struct and the quaternion helpers.

#include <cuda_runtime.h>
#include <math.h>

#define MAXB 32            // bodies
#define MAXJ (MAXB - 1)    // joints
#define MAXD (MAXJ + 6)    // dofs
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

// ===========================================================================
// foot_positions: the world origins of a few bodies of each env (the feet,
// which the env reads after every reset and every control step), a thread
// per (env, body).
//
// Replaces the plain forward kinematics over every body on the card
// (`forward_kinematics(model, q).pos[:, feet]`, physics/kinematics.py), a
// graph node per tensor op, ~46 a body. A thread walks only its body's chain
// of ancestors, root to body, with the pose in registers: pos_i = pos_p +
// R(quat_p) anchor_i and quat_i = quat_p [* jrot_i] * axis_angle(axis_i,
// q_j), the plain version's products in its order (with fixed joint
// rotations on every row, as the plain version multiplies every row). The
// body's own orientation moves no origin, so the walk stops at its position.
// Nothing is clamped and nothing exits early: a non-finite input propagates
// as in the plain version.
//
// Bound: latency. A thread runs ~60 dependent fp32 operations a link over up
// to 8 links; at the envs a step runs (16 to 4,096) the launch and one
// chain's latency are the time, and the rest of the card idles.
//
// chains: (nchains, MAXB + 1) int32, row c = [n, the n bodies from the
// root's child down to body c]; q (B, NB + 6), out (B, nchains, 3), both
// row-major.
// ===========================================================================

#define FOOT_THREADS 128  // threads per block of foot_positions

__global__ void __launch_bounds__(FOOT_THREADS)
foot_positions(const ModelData* __restrict__ gm, const int* __restrict__ chains, int nchains,
               const float* __restrict__ jrot, int B, const float* __restrict__ q,
               float* __restrict__ out) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)B * nchains) return;
  const ModelData& g = *gm;
  const float* const qe = q + t / nchains * (g.nb + 6);
  const int* const chain = chains + (t % nchains) * (MAXB + 1);
  float pos[3] = {qe[0], qe[1], qe[2]};
  float quat[4] = {qe[3], qe[4], qe[5], qe[6]};
  const int n = __ldg(chain);
  for (int k = 1; k <= n; ++k) {
    const int i = __ldg(chain + k);
    float r[3];
    qrot(quat, g.anchor[i], r);
    for (int a = 0; a < 3; ++a) pos[a] = pos[a] + r[a];
    if (k == n) break;
    float frame[4] = {quat[0], quat[1], quat[2], quat[3]};
    if (jrot != nullptr) {  // fixed frame rotation before the hinge
      const float jr[4] = {__ldg(jrot + 4 * i), __ldg(jrot + 4 * i + 1),
                           __ldg(jrot + 4 * i + 2), __ldg(jrot + 4 * i + 3)};
      qmul(quat, jr, frame);
    }
    float sh, ch;
    sincosf(0.5f * qe[6 + i], &sh, &ch);
    const float hinge[4] = {ch, g.axis[i][0] * sh, g.axis[i][1] * sh, g.axis[i][2] * sh};
    qmul(frame, hinge, quat);
  }
  for (int a = 0; a < 3; ++a) out[3 * t + a] = pos[a];
}

// ===========================================================================
// control_step_warp<PD, PLANK, ROT>: all eight variants, a warp per env
// (K1 <false, false, false> ... K2+K3+K4 <true, true, true>).
//
// Replaces pallas_step.py:733 in each of its specializations: K1 (pd=False,
// support_hy=None), K2 (support_hy=<float>), K3 (pd=True), K4 (joint_rot
// set) and their combinations. Planks (PLANK) add each stone's in-plane
// axes to the set-up and the box bound to the stone test. Stable PD (PD)
// adds only registers: lane j holds joint j's target, every lane the env's
// power, and the joint lanes add the PD torque and gains in the plain
// version's order; with PD false the kernel is K1's and K2's code as it
// was. Rotated frames (ROT) add one Hamilton product in the tree-level
// pass: the lane of a body whose `rot_rows` bit is set forms quat[p] *
// jrot[i] (read with __ldg) before the hinge's product, in the plain
// version's order; no shared memory and no sync more, and with ROT false
// the code is as it was. The three touch separate sections, so K2+K4 and
// K2+K3+K4 are the plank set-up and bound with the rotated tree pass, and
// no body is forked.
//
// Bound: fp32 operations (`control_step_flops`), as above; what holds a
// kernel back from that floor is occupancy and its scratch's latency. Here:
//  - each env has a warp, WARP_ENVS envs a block; the warps of a block
//    share nothing (only __syncwarp and shuffles, no __syncthreads), and a
//    warp past the batch leaves whole, so any B works;
//  - the per-env scratch lives in dynamic shared memory, laid out at launch
//    by `warp_layout` from the model's NB, NC and the stone count (Walker3D:
//    7.4 KB on discs, 7.8 KB on planks; Cassie 4.9 / 5.4 KB; the rotation
//    adds none), so 24 envs are resident on an SM: registers bound it (80 a
//    thread in every instantiation, 40-64 bytes spilled; a PD-only bound of
//    8 blocks, 64 registers, spilled 132-152 bytes and lost at 64 and 1,024
//    envs what it won at 4,096);
//  - each section's work is spread over the lanes: a stone per lane for the
//    normals and plank axes; a sphere's stone tests over a group of lanes;
//    forward kinematics, motion axes, body velocities and the RNEA's
//    accelerations one tree level at a time, a body per lane; per-body
//    inertias and forces, per-joint torques and mass-matrix entries (the
//    host's list of the ancestor pattern) one per lane; the Cholesky factor
//    a row per lane for each column, the forward solve beside it; the
//    backward solve on registers, a dof per lane, each unknown broadcast by
//    a shuffle;
//  - what a lane reads at its own body, joint or sphere comes from a copy of
//    the model in global memory (cached loads take any pattern), not from
//    the kernel parameter, whose loads serialise when the lanes' addresses
//    differ.
// The order of operations is the plain version's wherever a result feeds a
// decision or fixes its rounding: each sphere's first maximum over the
// stones (ties to the lowest stone, the ground last), contact forces summed
// into each body in sphere order, children added into each parent in
// decreasing index (the plain version's loop order), each Cholesky entry's
// updates in column order with the same pivot (computed column by column, so each
// entry's chain of updates runs in one lane's registers), the forward
// solve's likewise. Only the backward solve differs: it is right-looking
// here (the plain version's takes each row's dot product first), which
// changes fp32 rounding only.
// ===========================================================================

#define WARP_ENVS 4  // envs (warps) per block
#define FULL_MASK 0xffffffffu
// The model's tables (int32, built by `kernel_tables` in
// physics/step_kernel.py): bodies by tree level, each body's children, and
// the nonzeros of the mass matrix's ancestor pattern.
#define T_LEVEL 0                        // level_start[MAXB + 1] into order
#define T_ORDER (T_LEVEL + MAXB + 1)     // order[MAXB]: bodies by level, then index
#define T_CHILD (T_ORDER + MAXB)         // child_start[MAXB + 1] into children
#define T_CHILDREN (T_CHILD + MAXB + 1)  // children[MAXB]: each body's, decreasing
#define T_PAIRS (T_CHILDREN + MAXB)      // (k << 16) | l for each nonzero, l <= k
#define T_SIZE (T_PAIRS + MAXD * (MAXD + 1) / 2)

// One env's scratch in shared memory: offsets in floats and the size;
// mirrored by `warp_layout` in physics/step_kernel.py.
struct WarpLayout {
  int q, qd, sc, sn, su, sv, pos, quat, phi, vel, acc, fb, ic, F, A, rhs, cpt, cpv, cft, cfn,
      csi, size;
};

static WarpLayout warp_layout(int nb, int nc, int S, bool plank) {
  const int nd = nb + 5;
  WarpLayout L;
  int o = 0;
  L.q = o;    o += nb + 6;              // generalized coordinates
  L.qd = o;   o += nd;                  // velocities
  L.sc = o;   o += 3 * S;               // stone centers
  L.sn = o;   o += 3 * S;               // stone top normals
  L.su = o;   o += plank ? 3 * S : 0;   // plank in-plane axes
  L.sv = o;   o += plank ? 3 * S : 0;
  L.pos = o;  o += 3 * nb;              // body origins
  L.quat = o; o += 4 * nb;              // body orientations
  L.phi = o;  o += 6 * nd;              // motion axes
  L.vel = o;  o += 6 * nb;              // body velocities
  L.acc = o;  o += 6 * nb;              // RNEA accelerations
  L.fb = o;   o += 6 * nb;              // RNEA body forces
  L.ic = o;   o += 10 * nb;             // composite inertias
  L.F = o;    o += 6 * nd;              // Ic phi_k
  L.A = o;    o += nd * (nd + 1) / 2;   // packed lower triangle, then its factor
  L.rhs = o;  o += nd;                  // tau - C, then the new velocities
  L.cpt = o;  o += 3 * nc;              // contact sphere centers
  L.cpv = o;  o += 3 * nc;              // and their velocities
  L.cft = o;  o += 6 * nc;              // contact torque and force
  L.cfn = o;  o += nc;                  // normal force
  L.csi = o;  o += nc;                  // stone index
  L.size = o;
  return L;
}

// R(q) row-major
__device__ __forceinline__ void quat_matrix(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1 - 2 * (yy + zz); R[1] = 2 * (xy - wz);     R[2] = 2 * (xz + wy);
  R[3] = 2 * (xy + wz);     R[4] = 1 - 2 * (xx + zz); R[5] = 2 * (yz - wx);
  R[6] = 2 * (xz - wy);     R[7] = 2 * (yz + wx);     R[8] = 1 - 2 * (xx + yy);
}

// PD: stable-PD actuation toward target_in (NJ, B) scaled by power_in (B,);
// PLANK: box support with lateral bound hy_margin (= support_hy + margin);
// ROT: fixed joint rotations jrot_in (NB, 4) wxyz on the rows set in rot_rows.
template <bool PD, bool PLANK, bool ROT>
__global__ void __launch_bounds__(WARP_ENVS * 32, 6)
control_step_warp(const __grid_constant__ ModelData m, const ModelData* __restrict__ gm,
                  const WarpLayout lay, int B, int S, float hy_margin, unsigned int rot_rows,
                  const float* __restrict__ jrot_in, int nlev, int npairs,
                  const int* __restrict__ tab,
                  const float* __restrict__ q_in, const float* __restrict__ qd_in,
                  const float* __restrict__ tau_in, const float* __restrict__ target_in,
                  const float* __restrict__ power_in, const float* __restrict__ st_in,
                  const float* __restrict__ sr_in, const float* __restrict__ ug_in,
                  float* __restrict__ q_out, float* __restrict__ qd_out,
                  float* __restrict__ info_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * WARP_ENVS + warp;
  if (e >= B) return;  // the whole warp: no other warp waits on it
  const int NB = m.nb, NJ = NB - 1, ND = NB + 5, NQ = NB + 6, NC = m.nc;
  const float dt = m.dt;
  // arrays that the lanes index each by its own body, joint or sphere are
  // read from the model's copy in global memory (cached, any pattern);
  // the kernel parameter `m` serves reads that are the same in every lane
  const ModelData& g = *gm;
  float* const s = smem + warp * lay.size;
  float* const q = s + lay.q;
  float* const qd = s + lay.qd;
  float* const sc = s + lay.sc;
  float* const sn = s + lay.sn;
  float* const su = s + lay.su;
  float* const sv = s + lay.sv;
  float* const pos = s + lay.pos;
  float* const quat = s + lay.quat;
  float* const phi = s + lay.phi;
  float* const vel = s + lay.vel;
  float* const acc = s + lay.acc;
  float* const fb = s + lay.fb;
  float* const ic = s + lay.ic;
  float* const F = s + lay.F;
  float* const A = s + lay.A;
  float* const rhs = s + lay.rhs;
  float* const cpt = s + lay.cpt;
  float* const cpv = s + lay.cpv;
  float* const cft = s + lay.cft;
  float* const cfn = s + lay.cfn;
  float* const csi = s + lay.csi;

  for (int k = lane; k < NQ; k += 32) q[k] = q_in[k * B + e];
  for (int k = lane; k < ND; k += 32) qd[k] = qd_in[k * B + e];
  const float tau_j = lane < NJ ? tau_in[lane * B + e] : 0.0f;  // lane j: joint j
  float target_j = 0.0f, power = 0.0f;  // stable PD: joint j's target, the env's power
  if constexpr (PD) {
    if (lane < NJ) target_j = target_in[lane * B + e];
    power = power_in[e];
  }

  // stone centers and top normals (planks: the in-plane axes of the top),
  // once per control step, a stone per lane
  for (int st = lane; st < S; st += 32) {
    float* const c = sc + 3 * st;
    float* const n = sn + 3 * st;
    for (int a = 0; a < 3; ++a) c[a] = st_in[(st * 6 + a) * B + e];
    const float xt = st_in[(st * 6 + 4) * B + e], yt = st_in[(st * 6 + 5) * B + e];
    const float cx = cosf(xt), cy = cosf(yt);
    n[0] = sinf(yt) * cx;
    n[1] = -sinf(xt);
    n[2] = cy * cx;
    if constexpr (PLANK) {
      const float ph = st_in[(st * 6 + 3) * B + e];
      const float h[3] = {cosf(ph), sinf(ph), 0.0f};
      const float hn = dot3(h, n);
      float ux[3];
      for (int a = 0; a < 3; ++a) ux[a] = h[a] - hn * n[a];
      const float un = sqrtf(dot3(ux, ux) + 1e-12f);
      for (int a = 0; a < 3; ++a) su[3 * st + a] = ux[a] / un;
      cross3(n, su + 3 * st, sv + 3 * st);
    }
  }
  const float rim = sr_in[e] + m.margin;
  const bool use_ground = ug_in[e] != 0.0f;
  for (int t = lane; t < 36; t += 32) phi[t] = (t / 6 == t % 6) ? 1.0f : 0.0f;  // root dofs

  // a sphere's stone tests: nch lanes (a power of two) per sphere, each
  // over a run of cs stones
  int nch = 1;
  while (nch < 32 && 2 * nch * NC <= 32) nch <<= 1;
  const int cs = (S + nch - 1) / nch;
  const int my_c = lane / nch, my_first = (lane % nch) * cs;
  const bool sphere_lane = my_c < NC;

  // aggregates over substeps: lanes 0 and 1 hold feet 0 and 1, lane 0 the
  // force sum, lane j joint j's limit flag
  float foot_peak = 0.0f, foot_stone = -1.0f, fsum = 0.0f, at_limit = 0.0f;
  __syncwarp();

  for (int sub = 0; sub < m.substeps; ++sub) {
    // ---- the root's frame; each joint's axis_angle(axis_i, q_j) waits in
    // quat[i] for its level ------------------------------------------------
    for (int i = lane; i < NB; i += 32) {
      if (i == 0) {
        for (int a = 0; a < 3; ++a) pos[a] = q[a];
        for (int a = 0; a < 4; ++a) quat[a] = q[3 + a];
        for (int a = 0; a < 6; ++a) vel[a] = qd[a];
        for (int a = 0; a < 6; ++a) acc[a] = 0.0f;
        acc[5] = m.gravity;  // gravity as base acceleration
      } else {
        float sh, ch;
        sincosf(0.5f * q[6 + i], &sh, &ch);
        quat[4 * i] = ch;
        for (int a = 0; a < 3; ++a) quat[4 * i + 1 + a] = g.axis[i][a] * sh;
      }
    }
    __syncwarp();

    // ---- forward kinematics, motion axes, body velocities and the RNEA's
    // velocity-product accelerations, one tree level at a time ------------
    for (int d = 1; d < nlev; ++d) {
      const int lo = __ldg(tab + T_LEVEL + d), n = __ldg(tab + T_LEVEL + d + 1) - lo;
      if (lane < n) {
        const int i = __ldg(tab + T_ORDER + lo + lane), p = g.parent[i];
        const float* const qp = quat + 4 * p;
        const float an[3] = {g.anchor[i][0], g.anchor[i][1], g.anchor[i][2]};
        const float ax[3] = {g.axis[i][0], g.axis[i][1], g.axis[i][2]};
        float t[3], pi[3], qi[4], ph[6], vp[6], ap[6];
        for (int a = 0; a < 6; ++a) {
          vp[a] = vel[6 * p + a];
          ap[a] = acc[6 * p + a];
        }
        qrot(qp, an, t);
        for (int a = 0; a < 3; ++a) pi[a] = pos[3 * p + a] + t[a];
        const float qa[4] = {quat[4 * i], quat[4 * i + 1], quat[4 * i + 2], quat[4 * i + 3]};
        if constexpr (ROT) {
          float qf[4] = {qp[0], qp[1], qp[2], qp[3]};
          if ((rot_rows >> i) & 1u) {  // fixed frame rotation before the hinge
            const float jr[4] = {__ldg(jrot_in + 4 * i), __ldg(jrot_in + 4 * i + 1),
                                 __ldg(jrot_in + 4 * i + 2), __ldg(jrot_in + 4 * i + 3)};
            qmul(qp, jr, qf);
          }
          qmul(qf, qa, qi);
        } else {
          qmul(qp, qa, qi);
        }
        qrot(qi, ax, ph);  // world joint axis
        const float prel[3] = {pi[0] - pos[0], pi[1] - pos[1], pi[2] - pos[2]};
        cross3(prel, ph, ph + 3);
        const float qdi = qd[5 + i];
        float vi[6], jv[6], t0[3], t1[3], t2[3];
        for (int a = 0; a < 6; ++a) vi[a] = vp[a] + ph[a] * qdi;
        for (int a = 0; a < 6; ++a) jv[a] = vi[a] - vp[a];
        cross3(vi, jv, t0);      // w_v x w_m
        cross3(vi, jv + 3, t1);  // w_v x v_m
        cross3(vi + 3, jv, t2);  // v_v x w_m
        for (int a = 0; a < 3; ++a) {
          pos[3 * i + a] = pi[a];
          acc[6 * i + a] = ap[a] + t0[a];
          acc[6 * i + 3 + a] = ap[3 + a] + (t1[a] + t2[a]);
        }
        for (int a = 0; a < 4; ++a) quat[4 * i + a] = qi[a];
        for (int a = 0; a < 6; ++a) {
          phi[6 * (5 + i) + a] = ph[a];
          vel[6 * i + a] = vi[a];
        }
      }
      __syncwarp();
    }
    const float root[3] = {pos[0], pos[1], pos[2]};

    // ---- a body, a joint and a contact sphere per lane ---------------------
    for (int i = lane; i < NB; i += 32) {
      // world CoM and inertia, the composite inertia's own term, and the
      // RNEA body force I a + v x* I v (contacts are subtracted below)
      float R[9], cw[3], iw[6];
      quat_matrix(quat + 4 * i, R);
      for (int a = 0; a < 3; ++a)
        cw[a] = pos[3 * i + a] + (R[3 * a] * g.com[i][0] + R[3 * a + 1] * g.com[i][1] +
                                  R[3 * a + 2] * g.com[i][2]);
      int t = 0;
      for (int a = 0; a < 3; ++a)
        for (int b = a; b < 3; ++b)
          iw[t++] = R[3 * a] * g.inertia[i][0] * R[3 * b] +
                    R[3 * a + 1] * g.inertia[i][1] * R[3 * b + 1] +
                    R[3 * a + 2] * g.inertia[i][2] * R[3 * b + 2];
      const float mi = g.mass[i];
      const float c[3] = {cw[0] - root[0], cw[1] - root[1], cw[2] - root[2]};
      const float c2 = dot3(c, c);
      float* const I = ic + 10 * i;
      I[0] = iw[0] + mi * (c2 - c[0] * c[0]);
      I[1] = iw[1] - mi * c[0] * c[1];
      I[2] = iw[2] - mi * c[0] * c[2];
      I[3] = iw[3] + mi * (c2 - c[1] * c[1]);
      I[4] = iw[4] - mi * c[1] * c[2];
      I[5] = iw[5] + mi * (c2 - c[2] * c[2]);
      for (int a = 0; a < 3; ++a) I[6 + a] = mi * c[a];
      I[9] = mi;
      float v[6], ac[6], Iv[6], Ia[6], t0[3], t1[3], t2[3];
      for (int a = 0; a < 6; ++a) {
        v[a] = vel[6 * i + a];
        ac[a] = acc[6 * i + a];
      }
      inertia_mul(mi, c, iw, v, Iv);
      inertia_mul(mi, c, iw, ac, Ia);
      cross3(v, Iv, t0);          // w x n
      cross3(v + 3, Iv + 3, t1);  // v x f
      cross3(v, Iv + 3, t2);      // w x f
      for (int a = 0; a < 3; ++a) {
        fb[6 * i + a] = Ia[a] + (t0[a] + t1[a]);
        fb[6 * i + 3 + a] = Ia[3 + a] + t2[a];
      }
    }
    // joint torques (actuation + passive + limits); lane j keeps joint j's
    // implicit diagonal terms
    float damp = 0.0f, stiff = 0.0f;
    if (lane < NJ) {
      const int j = lane;
      const float qj = q[7 + j], qdj = qd[6 + j];
      const float below = fminf(qj - g.jlo[j], 0.0f);
      const float above = fmaxf(qj - g.jhi[j], 0.0f);
      const float out = (below < 0.0f || above > 0.0f) ? 1.0f : 0.0f;
      const float tau_lim = -m.limit_k * (below + above) - m.limit_c * qdj * out;
      const float passive = -g.jdamp[j] * qdj - g.jstiff[j] * (qj - g.jref[j]);
      float act = tau_j;
      damp = g.jdamp[j] + m.limit_c * out;
      stiff = g.jstiff[j] + m.limit_k * out;
      if constexpr (PD) {
        const float kp = g.kp[j], kd = g.kd[j];
        if (kp != 0.0f || kd != 0.0f) {
          // stable PD: explicit torque from the current substep state, the
          // gains on the implicit diagonals
          const float tlim = g.tlim[j];
          const float tpd = fminf(fmaxf(kp * (target_j - qj) - kd * qdj, -tlim), tlim);
          act = act + power * tpd;
          damp = damp + power * kd;
          stiff = stiff + power * kp;
        }
      }
      rhs[6 + j] = act + passive + tau_lim;  // tau_full; C is subtracted below
      at_limit = out;
    }
    if (lane < 6) rhs[lane] = 0.0f;
    // contact sphere centers and their velocities
    for (int c = lane; c < NC; c += 32) {
      const int b = g.cbody[c];
      float R[9], pt[3], rel_root[3], wr[3];
      quat_matrix(quat + 4 * b, R);
      for (int a = 0; a < 3; ++a)
        pt[a] = pos[3 * b + a] + (R[3 * a] * g.coff[c][0] + R[3 * a + 1] * g.coff[c][1] +
                                  R[3 * a + 2] * g.coff[c][2]);
      for (int a = 0; a < 3; ++a) rel_root[a] = pt[a] - root[a];
      cross3(vel + 6 * b, rel_root, wr);
      for (int a = 0; a < 3; ++a) {
        cpt[3 * c + a] = pt[a];
        cpv[3 * c + a] = vel[6 * b + 3 + a] + wr[a];
      }
    }
    __syncwarp();

    // ---- contacts: the deepest valid support of each sphere, stones in
    // order and the ground last, the first maximum winning ------------------
    float best = -INFINITY;
    int bi = my_first;
    float pt[3] = {0.0f, 0.0f, 0.0f}, rad = 0.0f;
    if (sphere_lane) {
      for (int a = 0; a < 3; ++a) pt[a] = cpt[3 * my_c + a];
      rad = g.crad[my_c];
      const int last = min(S, my_first + cs);
      for (int st = my_first; st < last; ++st) {
        const float* const n = sn + 3 * st;
        float rel[3], lat[3];
        for (int a = 0; a < 3; ++a) rel[a] = pt[a] - sc[3 * st + a];
        const float dn = dot3(rel, n);
        for (int a = 0; a < 3; ++a) lat[a] = rel[a] - dn * n[a];
        const float pen = rad - dn;
        bool on_top;
        if constexpr (PLANK)
          on_top = (fabsf(dot3(lat, su + 3 * st)) <= rim) &&
                   (fabsf(dot3(lat, sv + 3 * st)) <= hy_margin);
        else
          on_top = sqrtf(dot3(lat, lat)) <= rim;
        const bool ok = on_top && (pen > 0.0f) && (dn > -rad);
        if (ok && pen > best) { best = pen; bi = st; }
      }
    }
    // over the sphere's runs: the larger wins, a tie goes to the lower
    // stone (with no valid stone, stone 0, as in the plain version)
    for (int off = nch >> 1; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(FULL_MASK, best, off);
      const int oi = __shfl_xor_sync(FULL_MASK, bi, off);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    if (sphere_lane && lane % nch == 0) {
      const int c = my_c;
      const float gpen = rad - pt[2];
      if (use_ground && gpen > 0.0f && gpen > best) { best = gpen; bi = S; }
      const bool in_c = best > 0.0f;
      float n[3] = {0.0f, 0.0f, 1.0f};
      if (bi < S) for (int a = 0; a < 3; ++a) n[a] = sn[3 * bi + a];
      const float pv[3] = {cpv[3 * c], cpv[3 * c + 1], cpv[3 * c + 2]};
      const float rel_root[3] = {pt[0] - root[0], pt[1] - root[1], pt[2] - root[2]};
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
        cft[6 * c + a] = torque[a];
        cft[6 * c + 3 + a] = force[a];
      }
      cfn[c] = fn;
      csi[c] = (in_c && bi < S) ? (float)bi : -1.0f;
    }
    __syncwarp();

    // ---- each body's contact wrench in sphere order, out of its RNEA
    // force; the feet's strongest contacts and the force sum -------------
    for (int i = lane; i < NB; i += 32) {
      float f[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int c = 0; c < NC; ++c)
        if (m.cbody[c] == i)
          for (int a = 0; a < 6; ++a) f[a] += cft[6 * c + a];
      for (int a = 0; a < 6; ++a) fb[6 * i + a] = fb[6 * i + a] - f[a];
    }
    if (lane < 2) {
      float f = 0.0f, bp = -1.0f, si = -1.0f;
      for (int c = 0; c < NC; ++c) {
        if (m.cfoot[c] != lane) continue;
        f = fmaxf(f, cfn[c]);
        if (cfn[c] > bp) { bp = cfn[c]; si = csi[c]; }
      }
      const float st = f > 0.0f ? si : -1.0f;
      foot_peak = fmaxf(foot_peak, f);
      if (st >= 0.0f) foot_stone = st;
    }
    if (lane == 0) {
      float fsum_sub = 0.0f;
      for (int c = 0; c < NC; ++c) fsum_sub += cfn[c];
      fsum += fsum_sub;
    }
    __syncwarp();

    // ---- composite inertias and RNEA forces, leaves to root: a parent adds
    // its children in decreasing index, as the plain version's loop does; a
    // lane per (body, component) of a level ---------------------------------
    for (int d = nlev - 2; d >= 0; --d) {
      const int lo = __ldg(tab + T_LEVEL + d), n = __ldg(tab + T_LEVEL + d + 1) - lo;
      for (int t = lane; t < 16 * n; t += 32) {
        const int i = __ldg(tab + T_ORDER + lo + t / 16), a = t % 16;
        float* const x = a < 10 ? ic : fb;
        const int width = a < 10 ? 10 : 6, k = a < 10 ? a : a - 10;
        float v = x[width * i + k];
        const int end = __ldg(tab + T_CHILD + i + 1);
        for (int ch = __ldg(tab + T_CHILD + i); ch < end; ++ch)
          v += x[width * __ldg(tab + T_CHILDREN + ch) + k];
        x[width * i + k] = v;
      }
      __syncwarp();
    }

    // ---- F_k = Ic phi_k, the bias forces into rhs, a zeroed triangle ------
    for (int k = lane; k < ND; k += 32) {
      // F = Ic phi_k = [Ibar w + h x v ; m v - h x w]
      const float* const I = ic + 10 * (k < 6 ? 0 : k - 5);
      const float* const w = phi + 6 * k;
      const float* const v = w + 3;
      float hv[3], hw[3];
      cross3(I + 6, v, hv);
      cross3(I + 6, w, hw);
      float* const Fk = F + 6 * k;
      Fk[0] = I[0] * w[0] + I[1] * w[1] + I[2] * w[2] + hv[0];
      Fk[1] = I[1] * w[0] + I[3] * w[1] + I[4] * w[2] + hv[1];
      Fk[2] = I[2] * w[0] + I[4] * w[1] + I[5] * w[2] + hv[2];
      for (int a = 0; a < 3; ++a) Fk[3 + a] = I[9] * v[a] - hw[a];
      if (k < 6) {
        rhs[k] -= fb[k];
      } else {
        float sum = 0.0f;
        for (int a = 0; a < 6; ++a) sum += phi[6 * k + a] * fb[6 * (k - 5) + a];
        rhs[k] -= sum;
      }
    }
    for (int t = lane; t < ND * (ND + 1) / 2; t += 32) A[t] = 0.0f;
    __syncwarp();
    // the ancestor-masked mass matrix, an entry per lane
    for (int t = lane; t < npairs; t += 32) {
      const int kl = __ldg(tab + T_PAIRS + t), k = kl >> 16, l = kl & 0xffff;
      float sum = 0.0f;
      for (int a = 0; a < 6; ++a) sum += F[6 * k + a] * phi[6 * l + a];
      A[TRI(k, l)] = sum;
    }
    __syncwarp();
    // implicit diagonal: reg + dt D + dt^2 K
    if (lane < 6) A[TRI(lane, lane)] += m.reg;
    if (lane < NJ) A[TRI(6 + lane, 6 + lane)] += (m.reg + dt * damp) + (dt * dt) * stiff;
    __syncwarp();

    // ---- Cholesky and the forward solve L y = rhs, column by column. For
    // column k the lanes hold rows k + lane (and k + 32 + lane) and take
    // each entry through the updates of the right-looking factor, in its
    // order: A_ik - L_i0 L_k0 - L_i1 L_k1 - ..., then the pivot's scale
    // rsqrtf(fmaxf(., 1e-12f)); beside it, in every lane alike, y_k =
    // (rhs_k - L_k0 y_0 - ...) / L_kk. Rows left of column k are final, so
    // the loads of a column need no ordering with its stores --------------
    for (int k = 0; k < ND; ++k) {
      const float* const Lk = A + TRI(k, 0);
      const int i0 = k + lane, i1 = k + 32 + lane;
      const float* const L0 = A + TRI(i0 < ND ? i0 : k, 0);
      const float* const L1 = A + TRI(i1 < ND ? i1 : k, 0);
      float a0 = L0[k], a1 = L1[k], y = rhs[k];
      for (int j = 0; j < k; ++j) {
        const float lkj = Lk[j];
        a0 -= L0[j] * lkj;
        if (i1 < ND) a1 -= L1[j] * lkj;
        y -= lkj * rhs[j];
      }
      const float akk = __shfl_sync(FULL_MASK, a0, 0);  // lane 0 holds row k
      const float dk = rsqrtf(fmaxf(akk, 1e-12f));
      __syncwarp();  // row k is read above and written below
      if (i0 < ND) A[TRI(i0, k)] = a0 * dk;
      if (i1 < ND) A[TRI(i1, k)] = a1 * dk;
      if (lane == 0) rhs[k] = y / (akk * dk);
      __syncwarp();
    }
    // ---- the backward solve L^T x = y on registers, right-looking: lane l
    // holds dofs l and l + 32 ---------------------------------------------
    float r0 = lane < ND ? rhs[lane] : 0.0f;
    float r1 = lane + 32 < ND ? rhs[lane + 32] : 0.0f;
    __syncwarp();  // rhs is rewritten below
    for (int j = ND - 1; j >= 0; --j) {
      const float xj = __shfl_sync(FULL_MASK, j < 32 ? r0 : r1, j & 31) / A[TRI(j, j)];
      if (lane == (j & 31)) {
        if (j < 32) r0 = xj; else r1 = xj;
      }
      if (lane < j) r0 -= A[TRI(j, lane)] * xj;
      if (lane + 32 < j) r1 -= A[TRI(j, lane + 32)] * xj;
    }

    // ---- semi-implicit Euler: the new velocities into rhs ------------------
    if (lane < ND) rhs[lane] = fminf(fmaxf(qd[lane] + dt * r0, -m.max_qd), m.max_qd);
    if (lane + 32 < ND)
      rhs[lane + 32] = fminf(fmaxf(qd[lane + 32] + dt * r1, -m.max_qd), m.max_qd);
    __syncwarp();
    const float* const qdn = rhs;
    if (lane == 0) {
      const float omega_q[4] = {0.0f, qdn[0], qdn[1], qdn[2]};
      float root_new[3], dr[3], wdr[3], dq[4], qu[4];
      for (int a = 0; a < 3; ++a) root_new[a] = root[a] + dt * qdn[3 + a];
      for (int a = 0; a < 3; ++a) dr[a] = root_new[a] - root[a];
      cross3(qdn, dr, wdr);
      qmul(omega_q, q + 3, dq);
      for (int a = 0; a < 4; ++a) qu[a] = q[3 + a] + dt * (0.5f * dq[a]);
      const float qn =
          sqrtf(qu[0] * qu[0] + qu[1] * qu[1] + qu[2] * qu[2] + qu[3] * qu[3] + 1e-12f);
      for (int a = 0; a < 3; ++a) q[a] = root_new[a];
      for (int a = 0; a < 4; ++a) q[3 + a] = qu[a] / qn;
      for (int a = 0; a < 3; ++a) qd[a] = qdn[a];
      for (int a = 0; a < 3; ++a) qd[3 + a] = qdn[3 + a] + wdr[a];
    }
    if (lane < NJ) {
      q[7 + lane] += dt * qdn[6 + lane];
      qd[6 + lane] = qdn[6 + lane];
    }
    __syncwarp();
  }

  for (int k = lane; k < NQ; k += 32) q_out[k * B + e] = q[k];
  for (int k = lane; k < ND; k += 32) qd_out[k * B + e] = qd[k];
  // info rows: foot force x2, foot stone x2, foot peak force x2, at_limit x NJ, force sum
  if (lane < 2) {
    info_out[lane * B + e] = foot_peak;
    info_out[(2 + lane) * B + e] = foot_stone;
    info_out[(4 + lane) * B + e] = foot_peak;
  }
  if (lane < NJ) info_out[(6 + lane) * B + e] = at_limit;
  if (lane == 0) info_out[(6 + NJ) * B + e] = fsum;
}

// dynamic shared memory of a block of control_step_warp<PD, PLANK, ROT>,
// allowed past the 48 KB default and with the SM's L1 / shared split set
// for it
template <bool PD, bool PLANK, bool ROT>
static cudaError_t warp_prepare(const WarpLayout& lay, int* smem) {
  *smem = WARP_ENVS * lay.size * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(control_step_warp<PD, PLANK, ROT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(control_step_warp<PD, PLANK, ROT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <bool PD, bool PLANK, bool ROT>
static cudaError_t launch_warp(const ModelData* model, const ModelData* model_dev, int B, int S,
                               float hy_margin, unsigned int rot_rows, const float* jrot,
                               int nlev, int npairs, const int* tables,
                               const float* q, const float* qd, const float* tau,
                               const float* target, const float* power, const float* stones,
                               const float* stone_radius, const float* use_ground, float* q_out,
                               float* qd_out, float* info_out, cudaStream_t stream) {
  const WarpLayout lay = warp_layout(model->nb, model->nc, S, PLANK);
  int smem = 0;
  const cudaError_t err = warp_prepare<PD, PLANK, ROT>(lay, &smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + WARP_ENVS - 1) / WARP_ENVS;
  control_step_warp<PD, PLANK, ROT><<<blocks, WARP_ENVS * 32, smem, stream>>>(
      *model, model_dev, lay, B, S, hy_margin, rot_rows, jrot, nlev, npairs, tables, q, qd, tau,
      target, power, stones, stone_radius, use_ground, q_out, qd_out, info_out);
  return cudaSuccess;
}

// resident blocks of control_step_warp<PD, PLANK, ROT> on one SM (the
// occupancy calculator)
template <bool PD, bool PLANK, bool ROT>
static cudaError_t warp_blocks_per_sm(const WarpLayout& lay, int* blocks) {
  int smem = 0;
  cudaError_t err = warp_prepare<PD, PLANK, ROT>(lay, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, control_step_warp<PD, PLANK, ROT>, WARP_ENVS * 32, smem);
  return err;
}

extern "C" {

// sizeof(ModelData), so the binding can check that its mirror matches
int control_step_model_size(void) { return (int)sizeof(ModelData); }

// Floats of one env's scratch in control_step_warp (the same with and
// without PD or ROT), T_SIZE and WARP_ENVS, so the binding can check its
// mirrors (`warp_layout`, `kernel_tables`)
int control_step_warp_floats(int nb, int nc, int S, int plank) {
  return warp_layout(nb, nc, S, plank != 0).size;
}
int control_step_tables_size(void) { return T_SIZE; }
int control_step_warp_envs_per_block(void) { return WARP_ENVS; }

// Envs of control_step_warp<pd, plank, rot> resident on one SM for this
// model and stone count (the occupancy calculator), or -(CUDA error)
int control_step_warp_envs_per_sm(int nb, int nc, int S, int pd, int plank, int rot) {
  const WarpLayout lay = warp_layout(nb, nc, S, plank != 0);
  int blocks = 0;
  cudaError_t err;
  switch ((rot ? 4 : 0) | (pd ? 2 : 0) | (plank ? 1 : 0)) {
    case 0: err = warp_blocks_per_sm<false, false, false>(lay, &blocks); break;
    case 1: err = warp_blocks_per_sm<false, true, false>(lay, &blocks); break;
    case 2: err = warp_blocks_per_sm<true, false, false>(lay, &blocks); break;
    case 3: err = warp_blocks_per_sm<true, true, false>(lay, &blocks); break;
    case 4: err = warp_blocks_per_sm<false, false, true>(lay, &blocks); break;
    case 5: err = warp_blocks_per_sm<false, true, true>(lay, &blocks); break;
    case 6: err = warp_blocks_per_sm<true, false, true>(lay, &blocks); break;
    default: err = warp_blocks_per_sm<true, true, true>(lay, &blocks); break;
  }
  return err == cudaSuccess ? blocks * WARP_ENVS : -(int)err;
}

// Launch the (pd, plank, rot) variant on `stream`: control_step_warp with
// `model_dev`, a copy of *model on the device, and the model's `tables`
// (T_SIZE int32 on the device: nlev levels, npairs mass-matrix entries).
// target and power are read only when pd != 0, hy_margin only when
// plank != 0, rot_rows and jrot (NB, 4) only when rot != 0. Returns the
// CUDA error of the launch (0 = launched).
int control_step_launch(const ModelData* model, int B, int S, int pd, int plank, int rot,
                        float hy_margin, unsigned int rot_rows, int nlev, int npairs,
                        const ModelData* model_dev, const int* tables, const float* jrot,
                        const float* q, const float* qd, const float* tau, const float* target,
                        const float* power, const float* stones, const float* stone_radius,
                        const float* use_ground,
                        float* q_out, float* qd_out, float* info_out, void* stream) {
#define WARP_ARGS                                                                             \
  model, model_dev, B, S, hy_margin, rot_rows, jrot, nlev, npairs, tables, q, qd, tau, target, \
      power, stones, stone_radius, use_ground, q_out, qd_out, info_out, (cudaStream_t)stream
  cudaError_t err = cudaSuccess;
  switch ((rot ? 4 : 0) | (pd ? 2 : 0) | (plank ? 1 : 0)) {
    case 0: err = launch_warp<false, false, false>(WARP_ARGS); break;
    case 1: err = launch_warp<false, true, false>(WARP_ARGS); break;
    case 2: err = launch_warp<true, false, false>(WARP_ARGS); break;
    case 3: err = launch_warp<true, true, false>(WARP_ARGS); break;
    case 4: err = launch_warp<false, false, true>(WARP_ARGS); break;
    case 5: err = launch_warp<false, true, true>(WARP_ARGS); break;
    case 6: err = launch_warp<true, false, true>(WARP_ARGS); break;
    default: err = launch_warp<true, true, true>(WARP_ARGS); break;
  }
#undef WARP_ARGS
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Launch foot_positions on `stream`: out (B, nchains, 3) <- the world
// origins of the chains' last bodies at q (B, NB + 6), with `model_dev` a
// copy of the model on the device, `chains` (nchains, MAXB + 1) int32 on the
// device and jrot (NB, 4), or null for a model without fixed joint
// rotations. Returns the CUDA error of the launch (0 = launched).
int foot_positions_launch(const ModelData* model_dev, const int* chains, int nchains,
                          const float* jrot, int B, const float* q, float* out, void* stream) {
  const long threads = (long)B * nchains;
  if (threads == 0) return 0;
  foot_positions<<<(unsigned)((threads + FOOT_THREADS - 1) / FOOT_THREADS), FOOT_THREADS, 0,
                   (cudaStream_t)stream>>>(model_dev, chains, nchains, jrot, B, q, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
