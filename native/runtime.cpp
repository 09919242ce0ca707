// Native runtime core for forces_resilient_planner_tpu.
//
// The reference implements its entire runtime in C++ (plan_manage/src/*);
// here the accelerator owns the compute path and this library owns the host-side
// hot loops that sit between the device and the vehicle:
//   - the 100 Hz command interpolator (cmdTrajCallback, nmpc_solver.cpp:865-987)
//   - yaw ramp / init-yaw rate limiting (callInitYaw, nmpc_solver.cpp:228-262)
//   - MPC-deque post-processing (yaw unwrap + terminal copy,
//     updateFORCESResults, nmpc_solver.cpp:524-551)
//   - a batch Amanatides-Woo raycaster with log-odds majority updates for
//     host-resident occupancy grids (raycastProcess, occ_map.cpp:441-533)
//
// Exposed as a plain C ABI consumed via ctypes (native/bindings.py).
// Build: cmake -G Ninja && ninja  (see native/CMakeLists.txt)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr int kNvar = 17;

inline void euler_to_rot(const double rpy[3], double R[9]) {
  const double cr = std::cos(rpy[0]), sr = std::sin(rpy[0]);
  const double cp = std::cos(rpy[1]), sp = std::sin(rpy[1]);
  const double cy = std::cos(rpy[2]), sy = std::sin(rpy[2]);
  R[0] = cy * cp; R[1] = cy * sp * sr - cr * sy; R[2] = cy * sp * cr + sy * sr;
  R[3] = cp * sy; R[4] = cy * cr + sy * sp * sr; R[5] = sy * sp * cr - cy * sr;
  R[6] = -sp;     R[7] = cp * sr;                R[8] = cp * cr;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Command interpolation (PUB_TRAJ branch).  mpc_output: (N+1, 17) row-major.
// Returns 1 and fills cmd[14] = [pos(3), vel(3), acc(3), rates(3), yaw,
// thrust] when inside the horizon; returns 0 when exhausted.
// ---------------------------------------------------------------------------
int frp_interpolate_command(const double* mpc_output, int n_stages,
                            double t_since_mpc, double dt, double mass,
                            double g, double* cmd) {
  if (t_since_mpc < 0.0) return 0;
  const int cur = static_cast<int>(t_since_mpc / dt);
  if (cur < 0 || cur >= n_stages - 1) return 0;
  const double frac = std::fmod(t_since_mpc, dt) / dt;
  double q[kNvar];
  const double* a = mpc_output + cur * kNvar;
  const double* b = mpc_output + (cur + 1) * kNvar;
  for (int i = 0; i < kNvar; ++i) q[i] = a[i] + frac * (b[i] - a[i]);

  double R[9];
  const double rpy[3] = {q[14], q[15], q[16]};
  euler_to_rot(rpy, R);
  // world thrust acceleration: R * [0,0,T]/m - g e3 (nmpc_solver.cpp:925-931)
  const double T = q[3];
  cmd[0] = q[8];  cmd[1] = q[9];  cmd[2] = q[10];
  cmd[3] = q[11]; cmd[4] = q[12]; cmd[5] = q[13];
  cmd[6] = R[2] * T / mass;
  cmd[7] = R[5] * T / mass;
  cmd[8] = R[8] * T / mass - g;
  cmd[9] = q[0]; cmd[10] = q[1]; cmd[11] = q[2];
  cmd[12] = q[16];
  cmd[13] = T;
  return 1;
}

// Rate-limited initial yaw rate (callInitYaw wrap + clamp, lines 237-257).
double frp_init_yaw_rate(double current_yaw, double init_yaw,
                         double max_yaw_dot) {
  double d = init_yaw - current_yaw;
  const double pi = 3.1415926;  // reference uses this constant exactly
  if (d > pi) d = 2 * pi - d;
  else if (d < -pi) d = d + 2 * pi;
  return std::max(-max_yaw_dot, std::min(max_yaw_dot, d));
}

// Yaw unwrap of solver outputs + terminal-row copy
// (updateFORCESResults, nmpc_solver.cpp:531-543).  In-place on (N+1, 17).
void frp_postprocess_output(double* mpc_output, int n_stages) {
  const double pi = 3.1415926;
  for (int i = 0; i < n_stages; ++i) {
    double& yaw = mpc_output[i * kNvar + 16];
    if (yaw < -pi) yaw += 2 * pi;
    else if (yaw > pi) yaw -= 2 * pi;
  }
  std::memcpy(mpc_output + n_stages * kNvar,
              mpc_output + (n_stages - 1) * kNvar, kNvar * sizeof(double));
}

// ---------------------------------------------------------------------------
// Batch backward raycast + log-odds majority update on a host grid.
// grid: (nx*ny*nz) float log-odds, layout x*ny*nz + y*nz + z (occ_map.cpp:92).
// points: (m, 3) doubles; cam: camera position.  Mirrors raycastProcess
// semantics: endpoint hit vote (or miss when clipped to max_ray), traversal
// miss votes, per-batch majority rule, clamped log-odds update.
// ---------------------------------------------------------------------------
void frp_raycast_update(float* grid, int nx, int ny, int nz,
                        const double origin[3], double resolution,
                        const double* points, const uint8_t* valid, int m,
                        const double cam[3], double min_ray, double max_ray,
                        float hit_log, float miss_log, float clamp_min,
                        float clamp_max) {
  const int64_t n_total = static_cast<int64_t>(nx) * ny * nz;
  std::vector<uint16_t> hits(n_total, 0), total(n_total, 0);
  std::vector<int64_t> touched;
  touched.reserve(4096);

  auto to_idx = [&](const double p[3]) -> int64_t {
    const int ix = static_cast<int>(std::floor((p[0] - origin[0]) / resolution));
    const int iy = static_cast<int>(std::floor((p[1] - origin[1]) / resolution));
    const int iz = static_cast<int>(std::floor((p[2] - origin[2]) / resolution));
    if (ix < 0 || iy < 0 || iz < 0 || ix >= nx || iy >= ny || iz >= nz)
      return -1;
    return (static_cast<int64_t>(ix) * ny + iy) * nz + iz;
  };
  auto vote = [&](int64_t idx, bool hit) {
    if (idx < 0) return;
    if (total[idx] == 0) touched.push_back(idx);
    total[idx]++;
    if (hit) hits[idx]++;
  };

  for (int i = 0; i < m; ++i) {
    if (!valid[i]) continue;
    double p[3] = {points[3 * i], points[3 * i + 1], points[3 * i + 2]};
    double d[3] = {p[0] - cam[0], p[1] - cam[1], p[2] - cam[2]};
    const double len = std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    if (len < min_ray) continue;
    bool hit = true;
    if (len > max_ray) {
      const double s = max_ray / len;
      p[0] = cam[0] + d[0] * s;
      p[1] = cam[1] + d[1] * s;
      p[2] = cam[2] + d[2] * s;
      hit = false;
    }
    vote(to_idx(p), hit);

    // Amanatides-Woo from endpoint voxel (excluded) back to camera voxel
    double s0[3] = {p[0] / resolution, p[1] / resolution, p[2] / resolution};
    double e0[3] = {cam[0] / resolution, cam[1] / resolution,
                    cam[2] / resolution};
    int x[3], x1[3], step[3];
    double tmax[3], tdelta[3];
    for (int k = 0; k < 3; ++k) {
      x[k] = static_cast<int>(std::floor(s0[k]));
      x1[k] = static_cast<int>(std::floor(e0[k]));
      const double dd = e0[k] - s0[k];
      step[k] = (dd > 0) - (dd < 0);
      if (dd == 0) {
        tmax[k] = 1e300;
        tdelta[k] = 1e300;
      } else {
        double frac = s0[k] - std::floor(s0[k]);
        tmax[k] = (dd > 0 ? (1.0 - frac) / dd : frac / (-dd));
        tdelta[k] = std::fabs(1.0 / dd);
      }
    }
    for (int guard = 0; guard < 4 * (nx + ny + nz); ++guard) {
      if (x[0] == x1[0] && x[1] == x1[1] && x[2] == x1[2]) break;
      int axis = 0;
      if (tmax[1] < tmax[axis]) axis = 1;
      if (tmax[2] < tmax[axis]) axis = 2;
      x[axis] += step[axis];
      tmax[axis] += tdelta[axis];
      if (x[0] >= 0 && x[1] >= 0 && x[2] >= 0 && x[0] < nx && x[1] < ny &&
          x[2] < nz) {
        vote((static_cast<int64_t>(x[0]) * ny + x[1]) * nz + x[2], false);
      }
    }
  }

  for (int64_t idx : touched) {
    const float upd =
        (hits[idx] >= total[idx] - hits[idx]) ? hit_log : miss_log;
    grid[idx] =
        std::max(clamp_min, std::min(clamp_max, grid[idx] + upd));
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Latest-solution hand-off ring (seqlock double buffer).
//
// The reference shares the MPC solution deque `pre_mpc_output_` between the
// 20 Hz solve callback and the 100 Hz command callback with NO
// synchronization (nmpc_solver.cpp:527 written / 865-987 read across a
// 4-thread ros::MultiThreadedSpinner, resilient_planner_node.cpp:14) — it
// relies on timing luck.  This makes the hand-off explicit and lock-free:
// one writer (solver loop) publishes whole solutions, one reader (command
// loop) always sees a consistent latest snapshot, wait-free for the writer.
// ---------------------------------------------------------------------------

namespace {

struct CmdRing {
  int stride;                       // doubles per payload
  std::vector<double> buf;          // 2 * (stride + 1): payload + t_start
  std::atomic<uint64_t> seq{0};     // odd while writing; /2 %2 = live slot
};

}  // namespace

extern "C" {

void* frp_ring_create(int stride) {
  auto* r = new CmdRing();
  r->stride = stride;
  r->buf.assign(2 * (stride + 1), 0.0);
  return r;
}

void frp_ring_destroy(void* ring) { delete static_cast<CmdRing*>(ring); }

// Publish one solution (payload[stride], timestamp).  Single writer.
void frp_ring_push(void* ring, const double* payload, double t_start) {
  auto* r = static_cast<CmdRing*>(ring);
  const uint64_t s0 = r->seq.load(std::memory_order_relaxed);
  const int slot = static_cast<int>((s0 / 2 + 1) % 2);  // write the spare
  r->seq.store(s0 + 1, std::memory_order_release);      // mark writing (odd)
  double* dst = r->buf.data() + slot * (r->stride + 1);
  std::memcpy(dst, payload, r->stride * sizeof(double));
  dst[r->stride] = t_start;
  r->seq.store(s0 + 2, std::memory_order_release);      // flip live slot
}

// Read the latest consistent snapshot.  Returns 1 on success (and fills
// payload + t_start), 0 if nothing has been published yet.  Single reader;
// retries while the writer is mid-publish.
int frp_ring_latest(void* ring, double* payload, double* t_start) {
  auto* r = static_cast<CmdRing*>(ring);
  for (;;) {
    const uint64_t s0 = r->seq.load(std::memory_order_acquire);
    if (s0 == 0) return 0;
    if (s0 & 1) continue;                                // writer active
    const int slot = static_cast<int>((s0 / 2) % 2);
    const double* src = r->buf.data() + slot * (r->stride + 1);
    std::memcpy(payload, src, r->stride * sizeof(double));
    *t_start = src[r->stride];
    if (r->seq.load(std::memory_order_acquire) == s0) return 1;
  }
}

// Convenience: read-latest + interpolate in one call (the 100 Hz hot path
// does exactly this; one native call instead of two + a Python hop).
int frp_ring_command(void* ring, int n_stages, double t_now, double dt,
                     double mass, double g, double* cmd) {
  auto* r = static_cast<CmdRing*>(ring);
  std::vector<double> payload(r->stride);
  double t_start = 0.0;
  if (!frp_ring_latest(ring, payload.data(), &t_start)) return 0;
  return frp_interpolate_command(payload.data(), n_stages, t_now - t_start,
                                 dt, mass, g, cmd);
}

}  // extern "C"
