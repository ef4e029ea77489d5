// A MuJoCo-compatible rigid-body engine for a tree of hinge and slide joints
// (the seals MuJoCo envs' host path).
//
// It steps B copies of one compiled model through ``nstep`` calls of what
// MuJoCo's ``mj_step`` does with the Euler or the RK4 integrator, in float64:
//
//   kinematics -> subtree centres of mass, com-frame inertias, motion axes
//   -> the joint-space inertia M (composite rigid bodies, armature on the
//   diagonal) -> collision (sphere and capsule geoms against planes,
//   capsules against capsules) -> velocities -> passive forces (joint
//   springs and dampers, the inertia-box fluid model) -> bias forces
//   (recursive Newton-Euler: Coriolis, centrifugal, gravity) -> motor
//   forces (gear * ctrl clamped to ctrlrange) -> constraint rows (joint
//   limits, frictionless and pyramidal contacts) with MuJoCo's
//   soft-constraint impedance, stiffness and damping -> the constraint
//   solve -> Euler with implicit joint damping, or RK4 (four such forward
//   passes a step, the dampers explicit).
//
// The model is MuJoCo's compiled one (``envs/assets/<name>.json``, packed by
// ``envs/mujoco_native.py``), so MuJoCo's compiler (inertia from geoms,
// ``settotalmass``, ``invweight0``) need not be re-implemented. The
// formulas are MuJoCo's (engine_core_smooth.c, engine_collision_primitive.c,
// engine_core_constraint.c, engine_forward.c); the constraint solve is not
// MuJoCo's Newton iteration but an active-set Newton method with an exact
// line search on the same strictly convex cost, so it reaches the same
// unique minimiser, to rounding.
//
// Each step is deterministic and independent of the thread count: env i is
// stepped by one thread from its own state.
//
// Build (``native/build.py``, at first use):
//   g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread mjtree.cpp -o <lib>.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <stdexcept>
#include <thread>
#include <vector>

namespace {

constexpr double kMinVal = 1e-15;   // mjMINVAL
constexpr double kMinImp = 0.0001;  // mjMINIMP
constexpr double kMaxImp = 0.9999;  // mjMAXIMP

enum JointType : int { kSlide = 2, kHinge = 3 };
enum GeomType : int { kPlane = 0, kSphere = 2, kCapsule = 3 };
enum RowType : int { kRowLimit = 3, kRowFrictionless = 5, kRowPyramidal = 6 };  // mjtConstraint
enum Integrator : int { kEuler = 0, kRK4 = 1 };  // mjtIntegrator
constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// Small vector algebra, as MuJoCo's engine_util_* computes it.
// ---------------------------------------------------------------------------

inline double dot3(const double* a, const double* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

inline void cross3(double* r, const double* a, const double* b) {
  r[0] = a[1] * b[2] - a[2] * b[1];
  r[1] = a[2] * b[0] - a[0] * b[2];
  r[2] = a[0] * b[1] - a[1] * b[0];
}

inline void mulmat_vec3(double* r, const double* m, const double* v) {
  r[0] = m[0] * v[0] + m[1] * v[1] + m[2] * v[2];
  r[1] = m[3] * v[0] + m[4] * v[1] + m[5] * v[2];
  r[2] = m[6] * v[0] + m[7] * v[1] + m[8] * v[2];
}

inline void mul_quat(double* r, const double* a, const double* b) {
  double t[4] = {
      a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3],
      a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2],
      a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1],
      a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0],
  };
  std::memcpy(r, t, sizeof t);
}

inline void rot_vec_quat(double* r, const double* v, const double* q) {
  if (v[0] == 0 && v[1] == 0 && v[2] == 0) {
    r[0] = r[1] = r[2] = 0;
  } else if (q[0] == 1 && q[1] == 0 && q[2] == 0 && q[3] == 0) {
    std::memcpy(r, v, 3 * sizeof(double));
  } else {
    // tmp = q_w v + q_xyz x v;  r = v + 2 q_xyz x tmp
    double tmp[3] = {q[0] * v[0] + q[2] * v[2] - q[3] * v[1], q[0] * v[1] + q[3] * v[0] - q[1] * v[2],
                     q[0] * v[2] + q[1] * v[1] - q[2] * v[0]};
    r[0] = v[0] + 2 * (q[2] * tmp[2] - q[3] * tmp[1]);
    r[1] = v[1] + 2 * (q[3] * tmp[0] - q[1] * tmp[2]);
    r[2] = v[2] + 2 * (q[1] * tmp[1] - q[2] * tmp[0]);
  }
}

inline void quat2mat(double* r, const double* q) {
  if (q[0] == 1 && q[1] == 0 && q[2] == 0 && q[3] == 0) {
    const double eye[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    std::memcpy(r, eye, sizeof eye);
    return;
  }
  double q00 = q[0] * q[0], q01 = q[0] * q[1], q02 = q[0] * q[2], q03 = q[0] * q[3];
  double q11 = q[1] * q[1], q12 = q[1] * q[2], q13 = q[1] * q[3];
  double q22 = q[2] * q[2], q23 = q[2] * q[3], q33 = q[3] * q[3];
  r[0] = q00 + q11 - q22 - q33;
  r[4] = q00 - q11 + q22 - q33;
  r[8] = q00 - q11 - q22 + q33;
  r[1] = 2 * (q12 - q03);
  r[2] = 2 * (q13 + q02);
  r[3] = 2 * (q12 + q03);
  r[5] = 2 * (q23 - q01);
  r[6] = 2 * (q13 - q02);
  r[7] = 2 * (q23 + q01);
}

inline void normalize4(double* q) {
  double n = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  if (n < kMinVal) {
    q[0] = 1;
    q[1] = q[2] = q[3] = 0;
  } else if (std::fabs(n - 1) > kMinVal) {
    for (int k = 0; k < 4; ++k) q[k] /= n;
  }
}

inline double normalize3(double* v) {
  double n = std::sqrt(dot3(v, v));
  if (n < kMinVal) {
    v[0] = 1;
    v[1] = v[2] = 0;
  } else {
    for (int k = 0; k < 3; ++k) v[k] /= n;
  }
  return n;
}

// Spatial algebra in MuJoCo's com-based convention: a motion is
// [angular; linear], a force [torque; force], an inertia the 10-vector
// (xx, yy, zz, xy, xz, yz, m*dx, m*dy, m*dz, m) about a point.
inline void inert_com(double* r, const double* inert, const double* mat, const double* dif, double mass) {
  double tmp[9] = {mat[0] * inert[0], mat[3] * inert[0], mat[6] * inert[0],
                   mat[1] * inert[1], mat[4] * inert[1], mat[7] * inert[1],
                   mat[2] * inert[2], mat[5] * inert[2], mat[8] * inert[2]};
  r[0] = mat[0] * tmp[0] + mat[1] * tmp[3] + mat[2] * tmp[6];
  r[1] = mat[3] * tmp[1] + mat[4] * tmp[4] + mat[5] * tmp[7];
  r[2] = mat[6] * tmp[2] + mat[7] * tmp[5] + mat[8] * tmp[8];
  r[3] = mat[0] * tmp[1] + mat[1] * tmp[4] + mat[2] * tmp[7];
  r[4] = mat[0] * tmp[2] + mat[1] * tmp[5] + mat[2] * tmp[8];
  r[5] = mat[3] * tmp[2] + mat[4] * tmp[5] + mat[5] * tmp[8];
  r[0] += mass * (dif[1] * dif[1] + dif[2] * dif[2]);
  r[1] += mass * (dif[0] * dif[0] + dif[2] * dif[2]);
  r[2] += mass * (dif[0] * dif[0] + dif[1] * dif[1]);
  r[3] -= mass * dif[0] * dif[1];
  r[4] -= mass * dif[0] * dif[2];
  r[5] -= mass * dif[1] * dif[2];
  r[6] = mass * dif[0];
  r[7] = mass * dif[1];
  r[8] = mass * dif[2];
  r[9] = mass;
}

inline void mul_inert_vec(double* r, const double* i, const double* v) {
  r[0] = i[0] * v[0] + i[3] * v[1] + i[4] * v[2] - i[8] * v[4] + i[7] * v[5];
  r[1] = i[3] * v[0] + i[1] * v[1] + i[5] * v[2] + i[8] * v[3] - i[6] * v[5];
  r[2] = i[4] * v[0] + i[5] * v[1] + i[2] * v[2] - i[7] * v[3] + i[6] * v[4];
  r[3] = i[8] * v[1] - i[7] * v[2] + i[9] * v[3];
  r[4] = i[6] * v[2] - i[8] * v[0] + i[9] * v[4];
  r[5] = i[7] * v[0] - i[6] * v[1] + i[9] * v[5];
}

inline void cross_motion(double* r, const double* vel, const double* v) {
  r[0] = -vel[2] * v[1] + vel[1] * v[2];
  r[1] = vel[2] * v[0] - vel[0] * v[2];
  r[2] = -vel[1] * v[0] + vel[0] * v[1];
  r[3] = -vel[2] * v[4] + vel[1] * v[5];
  r[4] = vel[2] * v[3] - vel[0] * v[5];
  r[5] = -vel[1] * v[3] + vel[0] * v[4];
  r[3] += -vel[5] * v[1] + vel[4] * v[2];
  r[4] += vel[5] * v[0] - vel[3] * v[2];
  r[5] += -vel[4] * v[0] + vel[3] * v[1];
}

inline void cross_force(double* r, const double* vel, const double* f) {
  r[0] = -vel[2] * f[1] + vel[1] * f[2];
  r[1] = vel[2] * f[0] - vel[0] * f[2];
  r[2] = -vel[1] * f[0] + vel[0] * f[1];
  r[3] = -vel[2] * f[4] + vel[1] * f[5];
  r[4] = vel[2] * f[3] - vel[0] * f[5];
  r[5] = -vel[1] * f[3] + vel[0] * f[4];
  r[0] += -vel[5] * f[4] + vel[4] * f[5];
  r[1] += vel[5] * f[3] - vel[3] * f[5];
  r[2] += -vel[4] * f[3] + vel[3] * f[4];
}

inline double dot6(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] + a[4] * b[4] + a[5] * b[5];
}

// Dense Cholesky of the SPD n x n matrix A (lower factor in place), then
// solves A x = b in place.
bool cholesky(double* A, int n) {
  for (int j = 0; j < n; ++j) {
    double s = A[j * n + j];
    for (int k = 0; k < j; ++k) s -= A[j * n + k] * A[j * n + k];
    if (!(s > 0)) return false;
    double d = std::sqrt(s);
    A[j * n + j] = d;
    for (int i = j + 1; i < n; ++i) {
      double t = A[i * n + j];
      for (int k = 0; k < j; ++k) t -= A[i * n + k] * A[j * n + k];
      A[i * n + j] = t / d;
    }
  }
  return true;
}

void cholesky_solve(const double* L, int n, double* x) {
  for (int i = 0; i < n; ++i) {
    double t = x[i];
    for (int k = 0; k < i; ++k) t -= L[i * n + k] * x[k];
    x[i] = t / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double t = x[i];
    for (int k = i + 1; k < n; ++k) t -= L[k * n + i] * x[k];
    x[i] = t / L[i * n + i];
  }
}

// ---------------------------------------------------------------------------
// The compiled model (see ``envs/mujoco_native.py`` ``pack_model`` for the
// order of the two packed arrays).
// ---------------------------------------------------------------------------

struct Pair {  // a candidate contact pair with MuJoCo's mixed parameters
  int g1, g2, condim;
  double friction[5], solref[2], solimp[5], margin, gap, mu;
};

struct Model {
  int nq, nv, nu, nbody, njnt, ngeom, npair, integrator;
  double timestep, gravity[3], impratio, wind[3], density, viscosity;
  std::vector<int> body_parentid, body_rootid, body_jntadr, body_jntnum;
  std::vector<int> jnt_type, jnt_qposadr, jnt_dofadr, jnt_limited;
  std::vector<int> dof_bodyid, dof_parentid, dof_jntid;
  std::vector<int> geom_type, geom_bodyid, geom_condim;
  std::vector<int> actuator_dofadr, actuator_ctrllimited;
  std::vector<double> body_pos, body_quat, body_mass, body_subtreemass, body_ipos, body_iquat,
      body_inertia, body_invweight0;
  std::vector<double> jnt_pos, jnt_axis, jnt_stiffness, jnt_range, jnt_solref, jnt_solimp, jnt_margin;
  std::vector<double> qpos0, qpos_spring, dof_armature, dof_damping, dof_invweight0;
  std::vector<double> geom_size, geom_pos, geom_quat, geom_friction, geom_solref, geom_solimp, geom_solmix,
      geom_margin, geom_gap;
  std::vector<double> actuator_gear, actuator_ctrlrange;
  std::vector<Pair> pairs;
  int max_contacts = 0, max_rows = 0;
  bool implicit_damping = false;
};

struct Reader {
  const int* ip;
  const double* fp;
  std::vector<int> ints(size_t n) {
    std::vector<int> v(ip, ip + n);
    ip += n;
    return v;
  }
  std::vector<double> doubles(size_t n) {
    std::vector<double> v(fp, fp + n);
    fp += n;
    return v;
  }
};

// MuJoCo's mixing of two geoms' contact parameters (mj_contactParam). The
// pair's margin and gap are the sums of the geoms' (mujoco 3.10): a contact
// is found within margin + gap and becomes a constraint within the margin;
// ``margin`` below holds the former, ``margin - gap`` the latter.
Pair mix_pair(const Model& m, int g1, int g2) {
  Pair p{};
  p.g1 = g1;
  p.g2 = g2;
  p.condim = std::max(m.geom_condim[g1], m.geom_condim[g2]);
  double s1 = m.geom_solmix[g1], s2 = m.geom_solmix[g2], mix;
  if (s1 >= kMinVal && s2 >= kMinVal) {
    mix = s1 / (s1 + s2);
  } else if (s1 < kMinVal && s2 < kMinVal) {
    mix = 0.5;
  } else {
    mix = s1 < kMinVal ? 0.0 : 1.0;
  }
  const double* r1 = &m.geom_solref[2 * g1];
  const double* r2 = &m.geom_solref[2 * g2];
  for (int k = 0; k < 2; ++k) {
    p.solref[k] = (r1[0] > 0 && r2[0] > 0) ? mix * r1[k] + (1 - mix) * r2[k] : std::min(r1[k], r2[k]);
  }
  for (int k = 0; k < 5; ++k) p.solimp[k] = mix * m.geom_solimp[5 * g1 + k] + (1 - mix) * m.geom_solimp[5 * g2 + k];
  double fr[3];
  for (int k = 0; k < 3; ++k) fr[k] = std::max(m.geom_friction[3 * g1 + k], m.geom_friction[3 * g2 + k]);
  p.friction[0] = p.friction[1] = fr[0];
  p.friction[2] = fr[1];
  p.friction[3] = p.friction[4] = fr[2];
  p.gap = m.geom_gap[g1] + m.geom_gap[g2];
  p.margin = m.geom_margin[g1] + m.geom_margin[g2] + p.gap;
  p.mu = p.friction[0] * std::sqrt(1.0 / m.impratio);
  return p;
}

Model parse_model(const int* ints, const double* doubles) {
  Model m;
  Reader r{ints, doubles};
  auto head = r.ints(8);
  m.nq = head[0], m.nv = head[1], m.nu = head[2], m.nbody = head[3], m.njnt = head[4], m.ngeom = head[5],
  m.npair = head[6], m.integrator = head[7];
  int nb = m.nbody, nj = m.njnt, ng = m.ngeom, nv = m.nv, nu = m.nu;
  m.body_parentid = r.ints(nb);
  m.body_rootid = r.ints(nb);
  m.body_jntadr = r.ints(nb);
  m.body_jntnum = r.ints(nb);
  m.jnt_type = r.ints(nj);
  m.jnt_qposadr = r.ints(nj);
  m.jnt_dofadr = r.ints(nj);
  m.jnt_limited = r.ints(nj);
  m.geom_type = r.ints(ng);
  m.geom_bodyid = r.ints(ng);
  m.geom_condim = r.ints(ng);
  m.actuator_dofadr = r.ints(nu);
  m.actuator_ctrllimited = r.ints(nu);
  auto pair_geoms = r.ints(2 * m.npair);

  auto opt = r.doubles(10);
  m.timestep = opt[0];
  std::copy(opt.begin() + 1, opt.begin() + 4, m.gravity);
  m.impratio = opt[4];
  std::copy(opt.begin() + 5, opt.begin() + 8, m.wind);
  m.density = opt[8];
  m.viscosity = opt[9];
  m.body_pos = r.doubles(3 * nb);
  m.body_quat = r.doubles(4 * nb);
  m.body_mass = r.doubles(nb);
  m.body_subtreemass = r.doubles(nb);
  m.body_ipos = r.doubles(3 * nb);
  m.body_iquat = r.doubles(4 * nb);
  m.body_inertia = r.doubles(3 * nb);
  m.body_invweight0 = r.doubles(2 * nb);
  m.jnt_pos = r.doubles(3 * nj);
  m.jnt_axis = r.doubles(3 * nj);
  m.jnt_stiffness = r.doubles(nj);
  m.jnt_range = r.doubles(2 * nj);
  m.jnt_solref = r.doubles(2 * nj);
  m.jnt_solimp = r.doubles(5 * nj);
  m.jnt_margin = r.doubles(nj);
  m.qpos0 = r.doubles(m.nq);
  m.qpos_spring = r.doubles(m.nq);
  m.dof_armature = r.doubles(nv);
  m.dof_damping = r.doubles(nv);
  m.dof_invweight0 = r.doubles(nv);
  m.geom_size = r.doubles(3 * ng);
  m.geom_pos = r.doubles(3 * ng);
  m.geom_quat = r.doubles(4 * ng);
  m.geom_friction = r.doubles(3 * ng);
  m.geom_solref = r.doubles(2 * ng);
  m.geom_solimp = r.doubles(5 * ng);
  m.geom_solmix = r.doubles(ng);
  m.geom_margin = r.doubles(ng);
  m.geom_gap = r.doubles(ng);
  m.actuator_gear = r.doubles(nu);
  m.actuator_ctrlrange = r.doubles(2 * nu);

  // one dof per hinge or slide joint; a dof's parent is the last dof of the
  // nearest ancestor body that has one
  m.dof_bodyid.assign(nv, 0);
  m.dof_jntid.assign(nv, 0);
  m.dof_parentid.assign(nv, -1);
  std::vector<int> last_dof(nb, -1);
  for (int b = 1; b < nb; ++b) {
    int prev = last_dof[m.body_parentid[b]];
    for (int j = m.body_jntadr[b]; j < m.body_jntadr[b] + m.body_jntnum[b]; ++j) {
      int d = m.jnt_dofadr[j];
      m.dof_bodyid[d] = b;
      m.dof_jntid[d] = j;
      m.dof_parentid[d] = prev;
      prev = d;
    }
    last_dof[b] = prev;
  }
  for (int p = 0; p < m.npair; ++p) {
    m.pairs.push_back(mix_pair(m, pair_geoms[2 * p], pair_geoms[2 * p + 1]));
    int g2 = pair_geoms[2 * p + 1];
    int n = m.geom_type[g2] == kCapsule ? 2 : 1;  // a capsule's two ends, or two near-parallel capsules
    int condim = m.pairs.back().condim;
    m.max_contacts += n;
    m.max_rows += n * (condim == 1 ? 1 : 2 * (condim - 1));
  }
  for (int j = 0; j < nj; ++j) m.max_rows += m.jnt_limited[j] ? 2 : 0;
  for (int d = 0; d < nv; ++d) m.implicit_damping |= m.dof_damping[d] > 0;
  return m;
}

// ---------------------------------------------------------------------------
// Per-thread scratch: MuJoCo's mjData for one env at a time.
// ---------------------------------------------------------------------------

struct Contact {
  double pos[3], frame[9], dist;
  int pair;
};

struct Data {
  std::vector<double> xpos, xquat, xmat, xipos, ximat, xanchor, xaxis, geom_xpos, geom_xmat, subtree_com,
      cinert, crb, cdof, cvel, cdof_dot, cacc, cfrc, M, qfrc_bias, qfrc_passive, qfrc_actuator, qfrc_smooth,
      qacc_smooth, qacc, qfrc_constraint, L, H, acc, a_new, p;
  std::vector<Contact> contacts;
  int nefc = 0;
  std::vector<int> efc_type;
  std::vector<double> efc_J, efc_pos, efc_margin, efc_diag, efc_R, efc_D, efc_aref, efc_vel, efc_force,
      jar, jar_new, Jp, jac, jacr, qfrc_fluid, rk_q, rk_v, rk_f, rk_dx;
  std::vector<char> active, active_new;
  std::vector<std::pair<double, int>> breaks;

  explicit Data(const Model& m) {
    int nb = m.nbody, nv = m.nv, nr = m.max_rows;
    xpos.assign(3 * nb, 0);
    xquat.assign(4 * nb, 0);
    xmat.assign(9 * nb, 0);
    xipos.assign(3 * nb, 0);
    ximat.assign(9 * nb, 0);
    xanchor.assign(3 * m.njnt, 0);
    xaxis.assign(3 * m.njnt, 0);
    geom_xpos.assign(3 * m.ngeom, 0);
    geom_xmat.assign(9 * m.ngeom, 0);
    subtree_com.assign(3 * nb, 0);
    cinert.assign(10 * nb, 0);
    crb.assign(10 * nb, 0);
    cdof.assign(6 * nv, 0);
    cvel.assign(6 * nb, 0);
    cdof_dot.assign(6 * nv, 0);
    cacc.assign(6 * nb, 0);
    cfrc.assign(6 * nb, 0);
    M.assign(nv * nv, 0);
    L.assign(nv * nv, 0);
    H.assign(nv * nv, 0);
    for (auto* v : {&qfrc_bias, &qfrc_passive, &qfrc_actuator, &qfrc_smooth, &qacc_smooth, &qacc,
                    &qfrc_constraint, &acc, &a_new, &p}) {
      v->assign(nv, 0);
    }
    contacts.reserve(m.max_contacts);
    efc_type.assign(nr, 0);
    efc_J.assign(static_cast<size_t>(nr) * nv, 0);
    for (auto* v : {&efc_pos, &efc_margin, &efc_diag, &efc_R, &efc_D, &efc_aref, &efc_vel, &efc_force, &jar,
                    &jar_new, &Jp}) {
      v->assign(nr, 0);
    }
    active.assign(nr, 0);
    active_new.assign(nr, 0);
    breaks.reserve(nr);
    jac.assign(3 * nv, 0);
    jacr.assign(3 * nv, 0);
    qfrc_fluid.assign(nv, 0);
    rk_q.assign(4 * m.nq, 0);
    rk_v.assign(4 * nv, 0);
    rk_f.assign(4 * nv, 0);
    rk_dx.assign(2 * nv, 0);
  }
};

// -- position stage ---------------------------------------------------------

void kinematics(const Model& m, Data& d, const double* qpos) {
  d.xquat[0] = 1;
  d.xmat[0] = d.xmat[4] = d.xmat[8] = 1;
  d.ximat[0] = d.ximat[4] = d.ximat[8] = 1;
  for (int i = 1; i < m.nbody; ++i) {
    int pid = m.body_parentid[i];
    double xpos[3], xquat[4];
    if (pid) {
      mulmat_vec3(xpos, &d.xmat[9 * pid], &m.body_pos[3 * i]);
      for (int k = 0; k < 3; ++k) xpos[k] += d.xpos[3 * pid + k];
      mul_quat(xquat, &d.xquat[4 * pid], &m.body_quat[4 * i]);
    } else {
      std::memcpy(xpos, &m.body_pos[3 * i], sizeof xpos);
      std::memcpy(xquat, &m.body_quat[4 * i], sizeof xquat);
    }
    for (int j = m.body_jntadr[i]; j < m.body_jntadr[i] + m.body_jntnum[i]; ++j) {
      int qadr = m.jnt_qposadr[j];
      double xaxis[3], xanchor[3];
      rot_vec_quat(xaxis, &m.jnt_axis[3 * j], xquat);
      rot_vec_quat(xanchor, &m.jnt_pos[3 * j], xquat);
      for (int k = 0; k < 3; ++k) xanchor[k] += xpos[k];
      double q = qpos[qadr] - m.qpos0[qadr];
      if (m.jnt_type[j] == kSlide) {
        for (int k = 0; k < 3; ++k) xpos[k] += xaxis[k] * q;
      } else {
        double qloc[4] = {1, 0, 0, 0};
        if (q != 0) {
          double s = std::sin(q / 2);
          const double* ax = &m.jnt_axis[3 * j];
          qloc[0] = std::cos(q / 2);
          qloc[1] = ax[0] * s;
          qloc[2] = ax[1] * s;
          qloc[3] = ax[2] * s;
        }
        mul_quat(xquat, xquat, qloc);
        double vec[3];
        rot_vec_quat(vec, &m.jnt_pos[3 * j], xquat);
        for (int k = 0; k < 3; ++k) xpos[k] = xanchor[k] - vec[k];
      }
      std::memcpy(&d.xanchor[3 * j], xanchor, sizeof xanchor);
      std::memcpy(&d.xaxis[3 * j], xaxis, sizeof xaxis);
    }
    normalize4(xquat);
    std::memcpy(&d.xquat[4 * i], xquat, sizeof xquat);
    std::memcpy(&d.xpos[3 * i], xpos, sizeof xpos);
    quat2mat(&d.xmat[9 * i], xquat);
  }
  auto local2global = [&](double* gpos, double* gmat, const double* pos, const double* quat, int b) {
    mulmat_vec3(gpos, &d.xmat[9 * b], pos);
    for (int k = 0; k < 3; ++k) gpos[k] += d.xpos[3 * b + k];
    double q[4];
    mul_quat(q, &d.xquat[4 * b], quat);
    quat2mat(gmat, q);
  };
  for (int i = 1; i < m.nbody; ++i) {
    local2global(&d.xipos[3 * i], &d.ximat[9 * i], &m.body_ipos[3 * i], &m.body_iquat[4 * i], i);
  }
  for (int g = 0; g < m.ngeom; ++g) {
    local2global(&d.geom_xpos[3 * g], &d.geom_xmat[9 * g], &m.geom_pos[3 * g], &m.geom_quat[4 * g],
                 m.geom_bodyid[g]);
  }
}

void com_pos(const Model& m, Data& d) {
  for (int i = 0; i < m.nbody; ++i) {
    for (int k = 0; k < 3; ++k) d.subtree_com[3 * i + k] = d.xipos[3 * i + k] * m.body_mass[i];
  }
  for (int i = m.nbody - 1; i > 0; --i) {
    for (int k = 0; k < 3; ++k) d.subtree_com[3 * m.body_parentid[i] + k] += d.subtree_com[3 * i + k];
  }
  for (int i = 0; i < m.nbody; ++i) {
    if (m.body_subtreemass[i] < kMinVal) {
      for (int k = 0; k < 3; ++k) d.subtree_com[3 * i + k] = d.xipos[3 * i + k];
    } else {
      double s = 1.0 / m.body_subtreemass[i];
      for (int k = 0; k < 3; ++k) d.subtree_com[3 * i + k] *= s;
    }
  }
  std::fill(d.cinert.begin(), d.cinert.begin() + 10, 0.0);
  for (int i = 1; i < m.nbody; ++i) {
    const double* com = &d.subtree_com[3 * m.body_rootid[i]];
    double dif[3] = {d.xipos[3 * i] - com[0], d.xipos[3 * i + 1] - com[1], d.xipos[3 * i + 2] - com[2]};
    inert_com(&d.cinert[10 * i], &m.body_inertia[3 * i], &d.ximat[9 * i], dif, m.body_mass[i]);
    for (int j = m.body_jntadr[i]; j < m.body_jntadr[i] + m.body_jntnum[i]; ++j) {
      double* cdof = &d.cdof[6 * m.jnt_dofadr[j]];
      const double* axis = &d.xaxis[3 * j];
      if (m.jnt_type[j] == kSlide) {
        cdof[0] = cdof[1] = cdof[2] = 0;
        std::memcpy(cdof + 3, axis, 3 * sizeof(double));
      } else {
        double off[3] = {com[0] - d.xanchor[3 * j], com[1] - d.xanchor[3 * j + 1], com[2] - d.xanchor[3 * j + 2]};
        std::memcpy(cdof, axis, 3 * sizeof(double));
        cross3(cdof + 3, axis, off);
      }
    }
  }
}

// The joint-space inertia by composite rigid bodies, armature on the diagonal.
void crb(const Model& m, Data& d) {
  d.crb = d.cinert;
  for (int i = m.nbody - 1; i > 0; --i) {
    int p = m.body_parentid[i];
    if (p > 0) {
      for (int k = 0; k < 10; ++k) d.crb[10 * p + k] += d.crb[10 * i + k];
    }
  }
  int nv = m.nv;
  std::fill(d.M.begin(), d.M.end(), 0.0);
  for (int i = 0; i < nv; ++i) {
    double buf[6];
    mul_inert_vec(buf, &d.crb[10 * m.dof_bodyid[i]], &d.cdof[6 * i]);
    d.M[i * nv + i] = m.dof_armature[i];
    for (int j = i; j >= 0; j = m.dof_parentid[j]) {
      double v = dot6(&d.cdof[6 * j], buf);
      if (j == i) {
        d.M[i * nv + i] += v;
      } else {
        d.M[i * nv + j] = d.M[j * nv + i] = v;
      }
    }
  }
}

// The translational Jacobian of a point fixed to body b: [3, nv], row major;
// the rotational one too where ``jacr`` is given (mj_jac).
void jac_point(const Model& m, Data& d, int b, const double* point, double* jac, double* jacr = nullptr) {
  std::fill(jac, jac + 3 * m.nv, 0.0);
  if (jacr) std::fill(jacr, jacr + 3 * m.nv, 0.0);
  const double* com = &d.subtree_com[3 * m.body_rootid[b]];
  double off[3] = {point[0] - com[0], point[1] - com[1], point[2] - com[2]};
  int dof = -1;
  for (int bb = b; bb > 0 && dof < 0; bb = m.body_parentid[bb]) {
    int nj = m.body_jntnum[bb];
    if (nj) dof = m.jnt_dofadr[m.body_jntadr[bb] + nj - 1];
  }
  for (; dof >= 0; dof = m.dof_parentid[dof]) {
    const double* cd = &d.cdof[6 * dof];
    double t[3];
    cross3(t, cd, off);
    for (int k = 0; k < 3; ++k) jac[k * m.nv + dof] = cd[3 + k] + t[k];
    if (jacr) {
      for (int k = 0; k < 3; ++k) jacr[k * m.nv + dof] = cd[k];
    }
  }
}

// mju_makeFrame: the normal as first axis, the given tangent made orthogonal.
void make_frame(double* f) {
  normalize3(f);
  if (std::sqrt(dot3(f + 3, f + 3)) < 0.5) {
    f[3] = 0;
    f[4] = std::fabs(f[1]) < 0.5 ? 1 : 0;
    f[5] = std::fabs(f[1]) < 0.5 ? 0 : 1;
  }
  double s = dot3(f, f + 3);
  for (int k = 0; k < 3; ++k) f[3 + k] -= f[k] * s;
  normalize3(f + 3);
  cross3(f + 6, f, f + 3);
}

// Sphere (centre c, radius r) against the plane geom g1: a contact when the
// distance is within the margin; returns 1 if one was added.
int plane_sphere(const Model& m, Data& d, int pair, const double* c, double r, const double* tangent) {
  const Pair& p = m.pairs[pair];
  const double* ppos = &d.geom_xpos[3 * p.g1];
  const double* pmat = &d.geom_xmat[9 * p.g1];
  double normal[3] = {pmat[2], pmat[5], pmat[8]};
  double dif[3] = {c[0] - ppos[0], c[1] - ppos[1], c[2] - ppos[2]};
  double cdist = dot3(dif, normal);
  if (cdist > p.margin + r) return 0;
  Contact con{};
  con.pair = pair;
  con.dist = cdist - r;
  std::memcpy(con.frame, normal, sizeof normal);
  double s = r + con.dist / 2;
  for (int k = 0; k < 3; ++k) con.pos[k] = c[k] - normal[k] * s;
  if (tangent) std::memcpy(con.frame + 3, tangent, 3 * sizeof(double));
  make_frame(con.frame);
  d.contacts.push_back(con);
  return 1;
}

// Two spheres (mjraw_SphereSphere): the normal from the first centre to the
// second (the cross product of the geoms' axes if the centres coincide),
// the position halfway into the overlap; returns 1 if a contact was added.
int sphere_sphere(const Model& m, Data& d, int pair, const double* c1, double r1, const double* c2, double r2,
                  const double* mat1, const double* mat2) {
  double dif[3] = {c1[0] - c2[0], c1[1] - c2[1], c1[2] - c2[2]};
  double dist = std::sqrt(dot3(dif, dif)) - r1 - r2;
  if (dist > m.pairs[pair].margin) return 0;
  Contact con{};
  con.pair = pair;
  con.dist = dist;
  double* n = con.frame;
  for (int k = 0; k < 3; ++k) n[k] = c2[k] - c1[k];
  double len = std::sqrt(dot3(n, n));
  if (len < kMinVal) {
    double a1[3] = {mat1[2], mat1[5], mat1[8]}, a2[3] = {mat2[2], mat2[5], mat2[8]};
    cross3(n, a1, a2);
  }
  normalize3(n);
  double s = r1 + dist / 2;
  for (int k = 0; k < 3; ++k) con.pos[k] = c1[k] + n[k] * s;
  make_frame(con.frame);
  d.contacts.push_back(con);
  return 1;
}

// Two capsules (mjc_CapsuleCapsule): the closest points of the two
// segments, clamped to their ends, as spheres; for (numerically) parallel
// axes, the ends of one against their projections on the other, at most
// two contacts.
void capsule_capsule(const Model& m, Data& d, int pair) {
  int g1 = m.pairs[pair].g1, g2 = m.pairs[pair].g2;
  const double *pos1 = &d.geom_xpos[3 * g1], *mat1 = &d.geom_xmat[9 * g1];
  const double *pos2 = &d.geom_xpos[3 * g2], *mat2 = &d.geom_xmat[9 * g2];
  double r1 = m.geom_size[3 * g1], h1 = m.geom_size[3 * g1 + 1];
  double r2 = m.geom_size[3 * g2], h2 = m.geom_size[3 * g2 + 1];
  double axis1[3] = {mat1[2] * h1, mat1[5] * h1, mat1[8] * h1};
  double axis2[3] = {mat2[2] * h2, mat2[5] * h2, mat2[8] * h2};
  double dif[3] = {pos1[0] - pos2[0], pos1[1] - pos2[1], pos1[2] - pos2[2]};
  double ma = dot3(axis1, axis1), mb = -dot3(axis1, axis2), mc = dot3(axis2, axis2);
  double u = -dot3(axis1, dif), v = dot3(axis2, dif);
  double det = ma * mc - mb * mb;
  auto clip = [](double x) { return std::min(1.0, std::max(-1.0, x)); };
  auto at = [](double* out, const double* pos, const double* axis, double x) {
    for (int k = 0; k < 3; ++k) out[k] = pos[k] + axis[k] * x;
  };
  double v1[3], v2[3];
  if (std::fabs(det) >= kMinVal) {
    double x1 = (mc * u - mb * v) / det, x2 = (ma * v - mb * u) / det;
    if (x1 > 1) {
      x1 = 1;
      x2 = (v - mb) / mc;
    } else if (x1 < -1) {
      x1 = -1;
      x2 = (v + mb) / mc;
    }
    if (x2 > 1) {
      x2 = 1;
      x1 = clip((u - mb) / ma);
    } else if (x2 < -1) {
      x2 = -1;
      x1 = clip((u + mb) / ma);
    }
    at(v1, pos1, axis1, x1);
    at(v2, pos2, axis2, x2);
    sphere_sphere(m, d, pair, v1, r1, v2, r2, mat1, mat2);
    return;
  }
  // parallel: the ends of capsule 1, then those of capsule 2
  int n = 0;
  at(v1, pos1, axis1, 1);
  at(v2, pos2, axis2, clip((v - mb) / mc));
  n += sphere_sphere(m, d, pair, v1, r1, v2, r2, mat1, mat2);
  at(v1, pos1, axis1, -1);
  at(v2, pos2, axis2, clip((v + mb) / mc));
  n += sphere_sphere(m, d, pair, v1, r1, v2, r2, mat1, mat2);
  if (n >= 2) return;
  at(v1, pos1, axis1, clip((u - mb) / ma));
  at(v2, pos2, axis2, 1);
  n += sphere_sphere(m, d, pair, v1, r1, v2, r2, mat1, mat2);
  if (n >= 2) return;
  at(v1, pos1, axis1, clip((u + mb) / ma));
  at(v2, pos2, axis2, -1);
  sphere_sphere(m, d, pair, v1, r1, v2, r2, mat1, mat2);
}

void collision(const Model& m, Data& d) {
  d.contacts.clear();
  for (int p = 0; p < m.npair; ++p) {
    int g2 = m.pairs[p].g2;
    const double* pos = &d.geom_xpos[3 * g2];
    const double* mat = &d.geom_xmat[9 * g2];
    double r = m.geom_size[3 * g2];
    if (m.geom_type[m.pairs[p].g1] == kCapsule) {
      capsule_capsule(m, d, p);
    } else if (m.geom_type[g2] == kSphere) {
      plane_sphere(m, d, p, pos, r, nullptr);
    } else {  // capsule: each end sphere, the frame's tangent along the axis
      double axis[3] = {mat[2], mat[5], mat[8]};
      double h = m.geom_size[3 * g2 + 1], end[3];
      for (int k = 0; k < 3; ++k) end[k] = pos[k] + axis[k] * h;
      plane_sphere(m, d, p, end, r, axis);
      for (int k = 0; k < 3; ++k) end[k] = pos[k] - axis[k] * h;
      plane_sphere(m, d, p, end, r, axis);
    }
  }
}

// -- velocity stage ---------------------------------------------------------

void com_vel(const Model& m, Data& d, const double* qvel) {
  std::fill(d.cvel.begin(), d.cvel.begin() + 6, 0.0);
  for (int i = 1; i < m.nbody; ++i) {
    double cvel[6];
    std::memcpy(cvel, &d.cvel[6 * m.body_parentid[i]], sizeof cvel);
    for (int j = m.body_jntadr[i]; j < m.body_jntadr[i] + m.body_jntnum[i]; ++j) {
      int dof = m.jnt_dofadr[j];
      cross_motion(&d.cdof_dot[6 * dof], cvel, &d.cdof[6 * dof]);
      for (int k = 0; k < 6; ++k) cvel[k] += d.cdof[6 * dof + k] * qvel[dof];
    }
    std::memcpy(&d.cvel[6 * i], cvel, sizeof cvel);
  }
}

// MuJoCo's inertia-box fluid model (mj_inertiaBoxFluidModel) for body i:
// the box of the body's inertia, its 6-D velocity at ``xipos`` in the
// inertial frame less the wind, viscous and quadratic drag on each axis,
// rotated to the world and applied at ``xipos`` (mj_applyFT) into qfrc.
void inertia_box_fluid(const Model& m, Data& d, int i, double* qfrc) {
  const double* I = &m.body_inertia[3 * i];
  double mass = m.body_mass[i], box[3];
  box[0] = std::sqrt(std::max(kMinVal, I[1] + I[2] - I[0]) / mass * 6.0);
  box[1] = std::sqrt(std::max(kMinVal, I[0] + I[2] - I[1]) / mass * 6.0);
  box[2] = std::sqrt(std::max(kMinVal, I[0] + I[1] - I[2]) / mass * 6.0);
  const double* R = &d.ximat[9 * i];
  const double* cvel = &d.cvel[6 * i];
  const double* com = &d.subtree_com[3 * m.body_rootid[i]];
  const double* xipos = &d.xipos[3 * i];
  // mj_objectVelocity(mjOBJ_BODY, local): the com-based velocity moved to xipos, in the inertial frame
  double dif[3] = {xipos[0] - com[0], xipos[1] - com[1], xipos[2] - com[2]}, cros[3], lin[3], lvel[6];
  cross3(cros, dif, cvel);
  for (int k = 0; k < 3; ++k) lin[k] = cvel[3 + k] - cros[k];
  auto mul_t = [R](double* r, const double* v) {
    r[0] = R[0] * v[0] + R[3] * v[1] + R[6] * v[2];
    r[1] = R[1] * v[0] + R[4] * v[1] + R[7] * v[2];
    r[2] = R[2] * v[0] + R[5] * v[1] + R[8] * v[2];
  };
  mul_t(lvel, cvel);
  mul_t(lvel + 3, lin);
  double lwind[3];
  mul_t(lwind, m.wind);
  for (int k = 0; k < 3; ++k) lvel[3 + k] -= lwind[k];
  double lfrc[6] = {0, 0, 0, 0, 0, 0};
  if (m.viscosity > 0) {
    double diam = (box[0] + box[1] + box[2]) / 3.0;
    for (int k = 0; k < 3; ++k) lfrc[k] = lvel[k] * (-kPi * diam * diam * diam * m.viscosity);
    for (int k = 0; k < 3; ++k) lfrc[3 + k] = lvel[3 + k] * (-3.0 * kPi * diam * m.viscosity);
  }
  if (m.density > 0) {
    double rho = m.density;
    lfrc[3] -= 0.5 * rho * box[1] * box[2] * std::fabs(lvel[3]) * lvel[3];
    lfrc[4] -= 0.5 * rho * box[0] * box[2] * std::fabs(lvel[4]) * lvel[4];
    lfrc[5] -= 0.5 * rho * box[0] * box[1] * std::fabs(lvel[5]) * lvel[5];
    auto p4 = [](double x) { return x * x * x * x; };
    lfrc[0] -= rho * box[0] * (p4(box[1]) + p4(box[2])) * std::fabs(lvel[0]) * lvel[0] / 64.0;
    lfrc[1] -= rho * box[1] * (p4(box[0]) + p4(box[2])) * std::fabs(lvel[1]) * lvel[1] / 64.0;
    lfrc[2] -= rho * box[2] * (p4(box[0]) + p4(box[1])) * std::fabs(lvel[2]) * lvel[2] / 64.0;
  }
  double torque[3], force[3];
  mulmat_vec3(torque, R, lfrc);
  mulmat_vec3(force, R, lfrc + 3);
  int nv = m.nv;
  jac_point(m, d, i, xipos, d.jac.data(), d.jacr.data());
  for (int k = 0; k < nv; ++k) {
    double f = 0, t = 0;
    for (int a = 0; a < 3; ++a) {
      f += d.jac[a * nv + k] * force[a];
      t += d.jacr[a * nv + k] * torque[a];
    }
    qfrc[k] += f;
    qfrc[k] += t;
  }
}

void passive(const Model& m, Data& d, const double* qpos, const double* qvel) {
  for (int j = 0; j < m.njnt; ++j) {
    int dof = m.jnt_dofadr[j], q = m.jnt_qposadr[j];
    double spring = m.jnt_stiffness[j] == 0 ? 0.0 : -m.jnt_stiffness[j] * (qpos[q] - m.qpos_spring[q]);
    d.qfrc_passive[dof] = spring + -m.dof_damping[dof] * qvel[dof];
  }
  if (m.viscosity > 0 || m.density > 0) {
    double* fluid = d.qfrc_fluid.data();
    std::fill(fluid, fluid + m.nv, 0.0);
    for (int i = 1; i < m.nbody; ++i) {
      if (m.body_mass[i] >= kMinVal) inertia_box_fluid(m, d, i, fluid);
    }
    for (int k = 0; k < m.nv; ++k) d.qfrc_passive[k] += fluid[k];
  }
}

// Recursive Newton-Euler with zero joint accelerations: Coriolis,
// centrifugal and gravity forces.
void rne_bias(const Model& m, Data& d, const double* qvel) {
  std::vector<double>& cacc = d.cacc;
  std::vector<double>& frc = d.cfrc;
  std::fill(cacc.begin(), cacc.begin() + 6, 0.0);
  for (int k = 0; k < 3; ++k) cacc[3 + k] = -m.gravity[k];
  for (int i = 1; i < m.nbody; ++i) {
    double* a = &cacc[6 * i];
    std::memcpy(a, &cacc[6 * m.body_parentid[i]], 6 * sizeof(double));
    for (int j = m.body_jntadr[i]; j < m.body_jntadr[i] + m.body_jntnum[i]; ++j) {
      int dof = m.jnt_dofadr[j];
      for (int k = 0; k < 6; ++k) a[k] += d.cdof_dot[6 * dof + k] * qvel[dof];
    }
    double t[6], t1[6];
    mul_inert_vec(&frc[6 * i], &d.cinert[10 * i], a);
    mul_inert_vec(t, &d.cinert[10 * i], &d.cvel[6 * i]);
    cross_force(t1, &d.cvel[6 * i], t);
    for (int k = 0; k < 6; ++k) frc[6 * i + k] += t1[k];
  }
  for (int i = m.nbody - 1; i > 0; --i) {
    int p = m.body_parentid[i];
    if (p) {
      for (int k = 0; k < 6; ++k) frc[6 * p + k] += frc[6 * i + k];
    }
  }
  for (int i = 0; i < m.nv; ++i) d.qfrc_bias[i] = dot6(&d.cdof[6 * i], &frc[6 * m.dof_bodyid[i]]);
}

// -- constraints --------------------------------------------------------------

// MuJoCo's impedance d(x) over the constraint violation (mj_getImpedance),
// with d0 and dmax clamped to [mjMINIMP, mjMAXIMP] first.
double impedance(const double* solimp_in, double pos, double margin) {
  double s[5];
  std::memcpy(s, solimp_in, sizeof s);
  s[0] = std::min(kMaxImp, std::max(kMinImp, s[0]));
  s[1] = std::min(kMaxImp, std::max(kMinImp, s[1]));
  double imp;
  if (s[0] == s[1] || s[2] <= kMinVal) {
    imp = 0.5 * (s[0] + s[1]);
  } else {
    double x = std::fabs((pos - margin) / s[2]);
    if (x >= 1 || x <= 0) {
      imp = x >= 1 ? s[1] : s[0];
    } else {
      double y;
      if (s[4] == 1) {
        y = x;
      } else if (x <= s[3]) {
        y = std::pow(x, s[4]) / std::pow(s[3], s[4] - 1);
      } else {
        y = 1 - std::pow(1 - x, s[4]) / std::pow(1 - s[3], s[4] - 1);
      }
      imp = s[0] + y * (s[1] - s[0]);
    }
  }
  return std::min(kMaxImp, std::max(kMinImp, imp));
}

// Appends row r's impedance, reference acceleration and regulariser.
void finish_row(const Model& m, Data& d, int r, const double* solref, const double* solimp) {
  double imp = impedance(solimp, d.efc_pos[r], d.efc_margin[r]);
  double dmax = std::min(kMaxImp, std::max(kMinImp, solimp[1]));
  double K, B;
  if (solref[0] > 0) {
    double tc = std::max(solref[0], 2 * m.timestep), dr = solref[1];
    K = 1 / (dmax * dmax * tc * tc * dr * dr);
    B = 2 / (dmax * tc);
  } else {
    K = -solref[0] / (dmax * dmax);
    B = -solref[1] / dmax;
  }
  d.efc_aref[r] = -B * d.efc_vel[r] - K * imp * (d.efc_pos[r] - d.efc_margin[r]);
  d.efc_R[r] = std::max(kMinVal, (1 - imp) * d.efc_diag[r] / imp);
  d.efc_D[r] = 1 / d.efc_R[r];
}

void make_constraints(const Model& m, Data& d, const double* qpos, const double* qvel) {
  int nv = m.nv, r = 0;
  auto row_vel = [&](int row) {
    double v = 0;
    for (int k = 0; k < nv; ++k) v += d.efc_J[row * nv + k] * qvel[k];
    d.efc_vel[row] = v;
  };
  for (int j = 0; j < m.njnt; ++j) {
    if (!m.jnt_limited[j]) continue;
    double value = qpos[m.jnt_qposadr[j]];
    for (int side = -1; side <= 1; side += 2) {
      double dist = side * (m.jnt_range[2 * j + (side + 1) / 2] - value);
      if (dist < m.jnt_margin[j]) {
        double* J = &d.efc_J[r * nv];
        std::fill(J, J + nv, 0.0);
        J[m.jnt_dofadr[j]] = -side;
        d.efc_type[r] = kRowLimit;
        d.efc_pos[r] = dist;
        d.efc_margin[r] = m.jnt_margin[j];
        d.efc_diag[r] = m.dof_invweight0[m.jnt_dofadr[j]];
        row_vel(r);
        finish_row(m, d, r, &m.jnt_solref[2 * j], &m.jnt_solimp[5 * j]);
        ++r;
      }
    }
  }
  for (const Contact& c : d.contacts) {
    const Pair& p = m.pairs[c.pair];
    if (c.dist >= p.margin - p.gap) continue;  // in the gap: not a constraint
    int b1 = m.geom_bodyid[p.g1], b2 = m.geom_bodyid[p.g2];
    // J_frame = frame * (jac(b2) - jac(b1)), one [nv] row per frame axis
    double* jac = d.jac.data();
    double rel[3 * 64];
    jac_point(m, d, b2, c.pos, jac);
    std::memcpy(rel, jac, 3 * nv * sizeof(double));
    if (b1) {
      jac_point(m, d, b1, c.pos, jac);
      for (int k = 0; k < 3 * nv; ++k) rel[k] -= jac[k];
    }
    double Jf[3][64];
    for (int a = 0; a < 3; ++a) {
      for (int k = 0; k < nv; ++k) {
        Jf[a][k] = c.frame[3 * a] * rel[k] + c.frame[3 * a + 1] * rel[nv + k] + c.frame[3 * a + 2] * rel[2 * nv + k];
      }
    }
    double tran = m.body_invweight0[2 * b1] + m.body_invweight0[2 * b2];
    if (p.condim == 1) {  // frictionless: the normal row alone, diagApprox the translational weight
      double* J = &d.efc_J[r * nv];
      for (int q = 0; q < nv; ++q) J[q] = Jf[0][q];
      d.efc_type[r] = kRowFrictionless;
      d.efc_pos[r] = c.dist;
      d.efc_margin[r] = p.margin - p.gap;
      d.efc_diag[r] = tran;
      row_vel(r);
      finish_row(m, d, r, p.solref, p.solimp);
      ++r;
      continue;
    }
    // the pyramid's edges J_n +- f_k J_t_k; regulariser 2 mu^2 (1 + f_k^2) tran
    for (int k = 1; k < p.condim; ++k) {
      double f = p.friction[k - 1];
      for (int s = 1; s >= -1; s -= 2) {
        double* J = &d.efc_J[r * nv];
        for (int q = 0; q < nv; ++q) J[q] = Jf[0][q] + s * f * Jf[k][q];
        d.efc_type[r] = kRowPyramidal;
        d.efc_pos[r] = c.dist;
        d.efc_margin[r] = p.margin - p.gap;
        d.efc_diag[r] = 2 * p.mu * p.mu * (tran + f * f * tran);
        row_vel(r);
        finish_row(m, d, r, p.solref, p.solimp);
        ++r;
      }
    }
  }
  d.nefc = r;
}

// The cost  1/2 (a - a0)' M (a - a0) + sum_i 1/2 D_i min(0, J_i a - aref_i)^2.
// Its gradient at a, given the residuals jar = J a - aref: M a - f + J' D min(0, jar).
//
// Active-set Newton: at each iterate, the minimiser of the quadratic that
// keeps the current active rows; if that point has the same active set it
// is the minimiser of the cost, else an exact line search along the step
// (the cost is a convex piecewise quadratic along any line).
void solve(const Model& m, Data& d) {
  int nv = m.nv, ne = d.nefc;
  std::vector<double>& a = d.qacc;
  a = d.qacc_smooth;
  if (ne == 0) return;
  const double* J = d.efc_J.data();
  auto residuals = [&](const double* x, double* out) {
    for (int i = 0; i < ne; ++i) {
      double v = 0;
      for (int k = 0; k < nv; ++k) v += J[i * nv + k] * x[k];
      out[i] = v - d.efc_aref[i];
    }
  };
  std::vector<char>& active = d.active;
  std::vector<char>& active_new = d.active_new;
  std::vector<double>& a_new = d.a_new;
  std::vector<double>& p = d.p;
  std::vector<double>& jar_new = d.jar_new;
  std::vector<std::pair<double, int>>& breaks = d.breaks;
  for (int it = 0; it < 100; ++it) {
    residuals(a.data(), d.jar.data());
    for (int i = 0; i < ne; ++i) active[i] = d.jar[i] < 0;
    // H = M + J_A' D_A J_A;  rhs = f + J_A' D_A aref_A
    d.H = d.M;
    a_new = d.qfrc_smooth;
    for (int i = 0; i < ne; ++i) {
      if (!active[i]) continue;
      const double* Ji = J + i * nv;
      for (int r = 0; r < nv; ++r) {
        if (Ji[r] == 0) continue;
        double s = d.efc_D[i] * Ji[r];
        a_new[r] += s * d.efc_aref[i];
        for (int c = 0; c < nv; ++c) d.H[r * nv + c] += s * Ji[c];
      }
    }
    if (!cholesky(d.H.data(), nv)) throw std::runtime_error("constraint Hessian not positive definite");
    cholesky_solve(d.H.data(), nv, a_new.data());
    residuals(a_new.data(), jar_new.data());
    for (int i = 0; i < ne; ++i) active_new[i] = jar_new[i] < 0;
    if (std::equal(active.begin(), active.begin() + ne, active_new.begin())) {
      a = a_new;
      break;
    }
    // exact line search on g(t) = cost(a + t p), t > 0
    double step = 0, scale = 0;
    for (int k = 0; k < nv; ++k) {
      p[k] = a_new[k] - a[k];
      step = std::max(step, std::fabs(p[k]));
      scale = std::max(scale, std::fabs(a[k]));
    }
    // g'(t) = c0 + c1 t over the rows active on the current interval
    double c0 = 0, c1 = 0;
    for (int r = 0; r < nv; ++r) {
      double Mp = 0, Ma = 0;
      for (int c = 0; c < nv; ++c) {
        Mp += d.M[r * nv + c] * p[c];
        Ma += d.M[r * nv + c] * a[c];
      }
      c0 += p[r] * (Ma - d.qfrc_smooth[r]);
      c1 += p[r] * Mp;
    }
    breaks.clear();
    for (int i = 0; i < ne; ++i) {
      double jp = 0;
      for (int k = 0; k < nv; ++k) jp += J[i * nv + k] * p[k];
      d.Jp[i] = jp;
      bool on = d.jar[i] < 0 || (d.jar[i] == 0 && jp < 0);
      if (on) {
        c0 += d.efc_D[i] * jp * d.jar[i];
        c1 += d.efc_D[i] * jp * jp;
      }
      if (jp != 0) {
        double t = -d.jar[i] / jp;
        if (t > 0) breaks.emplace_back(t, i);
      }
    }
    std::sort(breaks.begin(), breaks.end());
    double t = -c0 / c1;
    for (const auto& [tb, i] : breaks) {
      if (t <= tb) break;
      double jp = d.Jp[i], sgn = jp > 0 ? -1 : 1;  // jp > 0: the row leaves the active set
      c0 += sgn * d.efc_D[i] * jp * d.jar[i];
      c1 += sgn * d.efc_D[i] * jp * jp;
      t = -c0 / c1;
    }
    for (int k = 0; k < nv; ++k) a[k] += t * p[k];
    if (t * step <= 1e-15 * (1 + scale)) break;
  }
  residuals(a.data(), d.jar.data());
  for (int i = 0; i < ne; ++i) d.efc_force[i] = d.jar[i] < 0 ? -d.efc_D[i] * d.jar[i] : 0.0;
}

// mj_forward up to the constraint-solved qacc, for one env.
void forward(const Model& m, Data& d, const double* qpos, const double* qvel, const double* ctrl) {
  int nv = m.nv;
  kinematics(m, d, qpos);
  com_pos(m, d);
  crb(m, d);
  collision(m, d);
  com_vel(m, d, qvel);
  passive(m, d, qpos, qvel);
  rne_bias(m, d, qvel);
  std::fill(d.qfrc_actuator.begin(), d.qfrc_actuator.end(), 0.0);
  for (int u = 0; u < m.nu; ++u) {
    double c = ctrl[u];
    if (m.actuator_ctrllimited[u]) {
      c = std::min(m.actuator_ctrlrange[2 * u + 1], std::max(m.actuator_ctrlrange[2 * u], c));
    }
    d.qfrc_actuator[m.actuator_dofadr[u]] += m.actuator_gear[u] * c;
  }
  for (int i = 0; i < nv; ++i) d.qfrc_smooth[i] = d.qfrc_passive[i] - d.qfrc_bias[i] + d.qfrc_actuator[i];
  d.L = d.M;
  if (!cholesky(d.L.data(), nv)) throw std::runtime_error("mass matrix not positive definite");
  d.qacc_smooth = d.qfrc_smooth;
  cholesky_solve(d.L.data(), nv, d.qacc_smooth.data());
  make_constraints(m, d, qpos, qvel);
  solve(m, d);
  std::fill(d.qfrc_constraint.begin(), d.qfrc_constraint.end(), 0.0);
  for (int i = 0; i < d.nefc; ++i) {
    if (d.efc_force[i] == 0) continue;
    for (int k = 0; k < nv; ++k) d.qfrc_constraint[k] += d.efc_J[i * nv + k] * d.efc_force[i];
  }
}

// mj_integratePos for hinges and slides: qpos += h v.
void integrate_pos(const Model& m, double* qpos, const double* v, double h) {
  for (int j = 0; j < m.njnt; ++j) qpos[m.jnt_qposadr[j]] += h * v[m.jnt_dofadr[j]];
}

// mj_step with RK4 (mj_RungeKutta(m, d, 4) after mj_forward): stage i
// starts from the step's state advanced by the A-weighted velocities and
// accelerations of the stages before it and runs a full forward pass; the
// step is the B-weighted sum (mj_advance). No implicit damping.
void step_rk4(const Model& m, Data& d, double* qpos, double* qvel, const double* ctrl) {
  static const double A[9] = {0.5, 0, 0, 0, 0.5, 0, 0, 0, 1};
  static const double B[4] = {1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0};
  int nq = m.nq, nv = m.nv;
  double h = m.timestep;
  double *X = d.rk_q.data(), *V = d.rk_v.data(), *F = d.rk_f.data(), *dv = d.rk_dx.data(), *da = dv + nv;
  std::memcpy(X, qpos, nq * sizeof(double));
  std::memcpy(V, qvel, nv * sizeof(double));
  forward(m, d, qpos, qvel, ctrl);
  std::memcpy(F, d.qacc.data(), nv * sizeof(double));
  for (int i = 1; i < 4; ++i) {
    std::fill(dv, dv + 2 * nv, 0.0);
    for (int j = 0; j < i; ++j) {
      double a = A[(i - 1) * 3 + j];
      for (int k = 0; k < nv; ++k) {
        dv[k] += V[j * nv + k] * a;
        da[k] += F[j * nv + k] * a;
      }
    }
    double *Xi = X + i * nq, *Vi = V + i * nv;
    std::memcpy(Xi, X, nq * sizeof(double));
    integrate_pos(m, Xi, dv, h);
    for (int k = 0; k < nv; ++k) Vi[k] = V[k] + da[k] * h;
    forward(m, d, Xi, Vi, ctrl);
    std::memcpy(F + i * nv, d.qacc.data(), nv * sizeof(double));
  }
  std::fill(dv, dv + 2 * nv, 0.0);
  for (int j = 0; j < 4; ++j) {
    for (int k = 0; k < nv; ++k) {
      dv[k] += V[j * nv + k] * B[j];
      da[k] += F[j * nv + k] * B[j];
    }
  }
  for (int k = 0; k < nv; ++k) qvel[k] = V[k] + da[k] * h;
  std::memcpy(qpos, X, nq * sizeof(double));
  integrate_pos(m, qpos, dv, h);
}

// mj_step with the Euler integrator: forward, then qvel += h qacc and
// qpos += h qvel, the damping integrated implicitly (M + h diag(b)).
void step(const Model& m, Data& d, double* qpos, double* qvel, const double* ctrl) {
  if (m.integrator == kRK4) {
    step_rk4(m, d, qpos, qvel, ctrl);
    return;
  }
  int nv = m.nv;
  double h = m.timestep;
  forward(m, d, qpos, qvel, ctrl);
  double* acc = d.acc.data();
  if (m.implicit_damping) {
    d.H = d.M;
    for (int i = 0; i < nv; ++i) d.H[i * nv + i] += h * m.dof_damping[i];
    if (!cholesky(d.H.data(), nv)) throw std::runtime_error("M + h B not positive definite");
    for (int i = 0; i < nv; ++i) acc[i] = d.qfrc_smooth[i] + d.qfrc_constraint[i];
    cholesky_solve(d.H.data(), nv, acc);
  } else {
    std::memcpy(acc, d.qacc.data(), nv * sizeof(double));
  }
  for (int i = 0; i < nv; ++i) qvel[i] += h * acc[i];
  integrate_pos(m, qpos, qvel, h);
}

void parallel_for(int n, int n_threads, const std::function<void(int, int, int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    fn(0, 0, n);
    return;
  }
  std::vector<std::thread> threads;
  int chunk = (n + n_threads - 1) / n_threads;
  for (int w = 0; w < n_threads; ++w) {
    int lo = w * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&fn, w, lo, hi] { fn(w, lo, hi); });
  }
  for (auto& th : threads) th.join();
}

struct Engine {
  Model model;
  int n_threads;
  std::vector<Data> scratch;  // one per thread
};

}  // namespace

extern "C" {

// Returns nullptr for a model the engine does not cover (nv above 64, a
// joint other than hinge or slide, an integrator other than Euler or RK4,
// a contact pair other than a sphere or capsule on a plane or two
// capsules, with condim 1 or 3).
void* mjt_create(const int* ints, const double* doubles, int n_threads) {
  auto* e = new Engine();
  e->model = parse_model(ints, doubles);
  const Model& m = e->model;
  bool ok = m.nv <= 64 && (m.integrator == kEuler || m.integrator == kRK4);
  for (int t : m.jnt_type) ok &= t == kSlide || t == kHinge;
  for (const Pair& p : m.pairs) {
    int t1 = m.geom_type[p.g1], t2 = m.geom_type[p.g2];
    ok &= (t1 == kPlane && (t2 == kSphere || t2 == kCapsule)) || (t1 == kCapsule && t2 == kCapsule);
    ok &= p.condim == 1 || p.condim == 3;  // frictionless, or sliding friction: the frame's two tangents
  }
  if (!ok) {
    delete e;
    return nullptr;
  }
  e->n_threads = n_threads > 0 ? n_threads : 1;
  for (int t = 0; t < e->n_threads; ++t) e->scratch.emplace_back(m);
  return e;
}

void mjt_destroy(void* handle) { delete static_cast<Engine*>(handle); }

// [max contacts, max constraint rows] of one env.
void mjt_capacity(void* handle, int* out) {
  auto* e = static_cast<Engine*>(handle);
  out[0] = e->model.max_contacts;
  out[1] = e->model.max_rows;
}

// Steps B envs ``nstep`` times in place: qpos [B, nq], qvel [B, nv], ctrl [B, nu].
// Returns 0, or 1 if a step failed (a matrix that is not positive definite).
int mjt_step(void* handle, int num_envs, double* qpos, double* qvel, const double* ctrl, int nstep) {
  auto* e = static_cast<Engine*>(handle);
  const Model& m = e->model;
  std::atomic<int> fail{0};
  parallel_for(num_envs, e->n_threads, [&](int w, int lo, int hi) {
    Data& d = e->scratch[w];
    try {
      for (int i = lo; i < hi; ++i) {
        for (int s = 0; s < nstep; ++s) step(m, d, qpos + i * m.nq, qvel + i * m.nv, ctrl + i * m.nu);
      }
    } catch (const std::runtime_error&) {
      fail = 1;
    }
  });
  return fail;
}

// mj_forward of one state, every stage copied out in this order (the
// sizes are those of ``mjt_capacity``; rows and contacts past the counts
// are left as they were):
//   counts: [ncon, nefc]
//   xpos [nbody,3], xmat [nbody,9], xipos [nbody,3], geom_xpos [ngeom,3],
//   geom_xmat [ngeom,9], subtree_com [nbody,3], cinert [nbody,10],
//   cdof [nv,6], cvel [nbody,6], M [nv,nv], qfrc_bias, qfrc_passive,
//   qfrc_actuator, qacc_smooth [nv], contact pos [C,3], frame [C,9],
//   dist [C], geoms [C,2], efc type [R], J [R,nv], pos, margin, diagApprox,
//   R, D, aref, vel, force [R], qacc, qfrc_constraint [nv].
int mjt_inspect(void* handle, const double* qpos, const double* qvel, const double* ctrl, int* counts,
                double* out) {
  auto* e = static_cast<Engine*>(handle);
  const Model& m = e->model;
  Data& d = e->scratch[0];
  try {
    forward(m, d, qpos, qvel, ctrl);
  } catch (const std::runtime_error&) {
    return 1;
  }
  int C = m.max_contacts, R = m.max_rows, ncon = static_cast<int>(d.contacts.size());
  counts[0] = ncon;
  counts[1] = d.nefc;
  auto put = [&out](const double* src, size_t n) {
    std::memcpy(out, src, n * sizeof(double));
    out += n;
  };
  for (auto* v : {&d.xpos, &d.xmat, &d.xipos, &d.geom_xpos, &d.geom_xmat, &d.subtree_com, &d.cinert}) {
    put(v->data(), v->size());
  }
  put(d.cdof.data(), 6 * m.nv);
  put(d.cvel.data(), 6 * m.nbody);
  for (auto* v : {&d.M, &d.qfrc_bias, &d.qfrc_passive, &d.qfrc_actuator, &d.qacc_smooth}) put(v->data(), v->size());
  for (int c = 0; c < ncon; ++c) put(d.contacts[c].pos, 3);
  out += 3 * (C - ncon);
  for (int c = 0; c < ncon; ++c) put(d.contacts[c].frame, 9);
  out += 9 * (C - ncon);
  for (int c = 0; c < ncon; ++c) put(&d.contacts[c].dist, 1);
  out += C - ncon;
  for (int c = 0; c < ncon; ++c) {
    const Pair& p = m.pairs[d.contacts[c].pair];
    double g[2] = {static_cast<double>(p.g1), static_cast<double>(p.g2)};
    put(g, 2);
  }
  out += 2 * (C - ncon);
  for (int r = 0; r < R; ++r) out[r] = d.efc_type[r];
  out += R;
  put(d.efc_J.data(), static_cast<size_t>(R) * m.nv);
  for (auto* v : {&d.efc_pos, &d.efc_margin, &d.efc_diag, &d.efc_R, &d.efc_D, &d.efc_aref, &d.efc_vel,
                  &d.efc_force}) {
    put(v->data(), R);
  }
  put(d.qacc.data(), m.nv);
  put(d.qfrc_constraint.data(), m.nv);
  return 0;
}

}  // extern "C"
