// Batched classic-control environment engine (the host-env path).
//
// B environments stepped in one C call, parallelized with std::thread over
// contiguous state arrays: no IPC and no Python in the inner loop. It backs
// ``native/cpp_env.py`` ``CppVectorEnv``, the host vector env whose chunks
// ``data/rollout.py`` ``HostCollector`` gathers on the CPU while the
// learners update on the card.
//
// The dynamics are the JAX package's engine's, unchanged, and follow
// Gymnasium's classic_control, as ``envs/classic.py`` does on the device.
//
// Build (``native/build.py``, at first use):
//   g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread envengine.cpp -o <lib>.so

#include <cmath>
#include <functional>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

struct EnvSpec {
  int state_dim;
  int obs_dim;
  int act_dim;      // 0 => discrete
  int n_actions;    // discrete action count (0 for continuous)
  int horizon;
};

enum EnvType : int {
  kCartPole = 0,
  kPendulum = 1,
  kMountainCar = 2,
  kMountainCarContinuous = 3,
};

// ---------------------------------------------------------------------------
// Per-env dynamics: state in/out, returns (reward, terminated) and writes obs.
// ---------------------------------------------------------------------------

inline void cartpole_reset(float* s, std::mt19937& rng) {
  std::uniform_real_distribution<float> d(-0.05f, 0.05f);
  for (int i = 0; i < 4; ++i) s[i] = d(rng);
}

inline void cartpole_obs(const float* s, float* obs) { std::memcpy(obs, s, 4 * sizeof(float)); }

inline void cartpole_step(float* s, const float* a, float* reward, uint8_t* terminated) {
  const float gravity = 9.8f, masscart = 1.0f, masspole = 0.1f;
  const float total_mass = masscart + masspole, length = 0.5f;
  const float polemass_length = masspole * length, force_mag = 10.0f, tau = 0.02f;
  const float theta_threshold = 12.0f * 2.0f * kPi / 360.0f, x_threshold = 2.4f;
  float x = s[0], x_dot = s[1], theta = s[2], theta_dot = s[3];
  float force = (a[0] > 0.5f) ? force_mag : -force_mag;
  float costheta = std::cos(theta), sintheta = std::sin(theta);
  float temp = (force + polemass_length * theta_dot * theta_dot * sintheta) / total_mass;
  float thetaacc = (gravity * sintheta - costheta * temp) /
                   (length * (4.0f / 3.0f - masspole * costheta * costheta / total_mass));
  float xacc = temp - polemass_length * thetaacc * costheta / total_mass;
  s[0] = x + tau * x_dot;
  s[1] = x_dot + tau * xacc;
  s[2] = theta + tau * theta_dot;
  s[3] = theta_dot + tau * thetaacc;
  *reward = 1.0f;
  *terminated = (std::fabs(s[0]) > x_threshold) || (std::fabs(s[2]) > theta_threshold);
}

inline void pendulum_reset(float* s, std::mt19937& rng) {
  std::uniform_real_distribution<float> dth(-kPi, kPi), dv(-1.0f, 1.0f);
  s[0] = dth(rng);
  s[1] = dv(rng);
}

inline void pendulum_obs(const float* s, float* obs) {
  obs[0] = std::cos(s[0]);
  obs[1] = std::sin(s[0]);
  obs[2] = s[1];
}

inline void pendulum_step(float* s, const float* a, float* reward, uint8_t* terminated) {
  const float max_speed = 8.0f, max_torque = 2.0f, dt = 0.05f;
  const float g = 10.0f, m = 1.0f, l = 1.0f;
  float th = s[0], thdot = s[1];
  float u = a[0];
  if (u > max_torque) u = max_torque;
  if (u < -max_torque) u = -max_torque;
  float angle = std::fmod(th + kPi, 2.0f * kPi);
  if (angle < 0) angle += 2.0f * kPi;
  angle -= kPi;
  float cost = angle * angle + 0.1f * thdot * thdot + 0.001f * u * u;
  float newthdot = thdot + (3.0f * g / (2.0f * l) * std::sin(th) + 3.0f / (m * l * l) * u) * dt;
  if (newthdot > max_speed) newthdot = max_speed;
  if (newthdot < -max_speed) newthdot = -max_speed;
  s[0] = th + newthdot * dt;
  s[1] = newthdot;
  *reward = -cost;
  *terminated = 0;
}

inline void mcar_reset(float* s, std::mt19937& rng) {
  std::uniform_real_distribution<float> d(-0.6f, -0.4f);
  s[0] = d(rng);
  s[1] = 0.0f;
}

inline void mcar_obs(const float* s, float* obs) { std::memcpy(obs, s, 2 * sizeof(float)); }

inline void mcar_step(float* s, const float* a, float* reward, uint8_t* terminated) {
  const float min_pos = -1.2f, max_pos = 0.6f, max_speed = 0.07f;
  const float goal = 0.5f, force = 0.001f, gravity = 0.0025f;
  float pos = s[0], vel = s[1];
  vel += (a[0] - 1.0f) * force + std::cos(3.0f * pos) * (-gravity);
  if (vel > max_speed) vel = max_speed;
  if (vel < -max_speed) vel = -max_speed;
  pos += vel;
  if (pos > max_pos) pos = max_pos;
  if (pos < min_pos) pos = min_pos;
  if (pos == min_pos && vel < 0) vel = 0;
  s[0] = pos;
  s[1] = vel;
  *reward = -1.0f;
  *terminated = (pos >= goal) && (vel >= 0.0f);
}

inline void mcarc_step(float* s, const float* a, float* reward, uint8_t* terminated) {
  const float min_pos = -1.2f, max_pos = 0.6f, max_speed = 0.07f;
  const float goal = 0.45f, power = 0.0015f;
  float pos = s[0], vel = s[1];
  float force = a[0];
  if (force > 1.0f) force = 1.0f;
  if (force < -1.0f) force = -1.0f;
  vel += force * power - 0.0025f * std::cos(3.0f * pos);
  if (vel > max_speed) vel = max_speed;
  if (vel < -max_speed) vel = -max_speed;
  pos += vel;
  if (pos > max_pos) pos = max_pos;
  if (pos < min_pos) pos = min_pos;
  if (pos == min_pos && vel < 0) vel = 0;
  s[0] = pos;
  s[1] = vel;
  *terminated = (pos >= goal) && (vel >= 0.0f);
  *reward = (*terminated ? 100.0f : 0.0f) - 0.1f * force * force;
}

const EnvSpec kSpecs[] = {
    /*CartPole*/ {4, 4, 0, 2, 500},
    /*Pendulum*/ {2, 3, 1, 0, 200},
    /*MountainCar*/ {2, 2, 0, 3, 200},
    /*MountainCarContinuous*/ {2, 2, 1, 0, 999},
};

struct Engine {
  int env_type;
  int num_envs;
  int max_episode_steps;
  bool fixed_horizon;
  EnvSpec spec;
  std::vector<float> state;        // [B, state_dim]
  std::vector<int32_t> t;          // [B]
  std::vector<double> ep_return;   // [B]
  std::vector<std::mt19937> rngs;  // per-env
  int n_threads;

  void reset_env(int i, float* obs_out) {
    float* s = &state[i * spec.state_dim];
    switch (env_type) {
      case kCartPole: cartpole_reset(s, rngs[i]); break;
      case kPendulum: pendulum_reset(s, rngs[i]); break;
      case kMountainCar:
      case kMountainCarContinuous: mcar_reset(s, rngs[i]); break;
    }
    t[i] = 0;
    ep_return[i] = 0.0;
    write_obs(i, obs_out);
  }

  void write_obs(int i, float* obs_out) {
    const float* s = &state[i * spec.state_dim];
    float* o = obs_out + i * spec.obs_dim;
    switch (env_type) {
      case kCartPole: cartpole_obs(s, o); break;
      case kPendulum: pendulum_obs(s, o); break;
      case kMountainCar:
      case kMountainCarContinuous: mcar_obs(s, o); break;
    }
  }

  void step_one(int i, const float* actions, float* obs, float* terminal_obs,
                float* reward, uint8_t* terminated, uint8_t* truncated,
                float* episode_return, int32_t* episode_length) {
    float* s = &state[i * spec.state_dim];
    const float* a = actions + i * (spec.act_dim > 0 ? spec.act_dim : 1);
    float r = 0.0f;
    uint8_t term = 0;
    switch (env_type) {
      case kCartPole: cartpole_step(s, a, &r, &term); break;
      case kPendulum: pendulum_step(s, a, &r, &term); break;
      case kMountainCar: mcar_step(s, a, &r, &term); break;
      case kMountainCarContinuous: mcarc_step(s, a, &r, &term); break;
    }
    if (fixed_horizon) term = 0;
    t[i] += 1;
    ep_return[i] += r;
    uint8_t trunc = (!term && max_episode_steps > 0 && t[i] >= max_episode_steps) ? 1 : 0;
    write_obs(i, terminal_obs);
    reward[i] = r;
    terminated[i] = term;
    truncated[i] = trunc;
    episode_return[i] = static_cast<float>(ep_return[i]);
    episode_length[i] = t[i];
    if (term || trunc) {
      reset_env(i, obs);
    } else {
      write_obs(i, obs);
    }
  }
};

void parallel_for(int n, int n_threads, const std::function<void(int, int)>& fn) {
  if (n_threads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int chunk = (n + n_threads - 1) / n_threads;
  for (int w = 0; w < n_threads; ++w) {
    int lo = w * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Env i draws its generator's seed from the (first_env + i)-th output of
// the seeder: a data-parallel rank's block of a larger batch passes the
// index of its first env and steps those envs exactly.
void* engine_create(int env_type, int num_envs, int max_episode_steps,
                    int fixed_horizon, uint64_t seed, int n_threads,
                    int first_env) {
  auto* e = new Engine();
  e->env_type = env_type;
  e->num_envs = num_envs;
  e->spec = kSpecs[env_type];
  e->max_episode_steps =
      max_episode_steps > 0 ? max_episode_steps : e->spec.horizon;
  e->fixed_horizon = fixed_horizon != 0;
  e->state.resize(static_cast<size_t>(num_envs) * e->spec.state_dim);
  e->t.assign(num_envs, 0);
  e->ep_return.assign(num_envs, 0.0);
  e->rngs.reserve(num_envs);
  std::mt19937_64 seeder(seed);
  seeder.discard(static_cast<unsigned long long>(first_env > 0 ? first_env : 0));
  for (int i = 0; i < num_envs; ++i) e->rngs.emplace_back(static_cast<uint32_t>(seeder()));
  e->n_threads = n_threads > 0 ? n_threads : 1;
  return e;
}

void engine_destroy(void* handle) { delete static_cast<Engine*>(handle); }

int engine_obs_dim(void* handle) { return static_cast<Engine*>(handle)->spec.obs_dim; }
int engine_act_dim(void* handle) { return static_cast<Engine*>(handle)->spec.act_dim; }
int engine_n_actions(void* handle) { return static_cast<Engine*>(handle)->spec.n_actions; }

void engine_reset(void* handle, float* obs_out) {
  auto* e = static_cast<Engine*>(handle);
  parallel_for(e->num_envs, e->n_threads, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) e->reset_env(i, obs_out);
  });
}

// actions: discrete envs pass float-cast action indices [B]; continuous [B, act_dim].
void engine_step(void* handle, const float* actions, float* obs,
                 float* terminal_obs, float* reward, uint8_t* terminated,
                 uint8_t* truncated, float* episode_return,
                 int32_t* episode_length) {
  auto* e = static_cast<Engine*>(handle);
  parallel_for(e->num_envs, e->n_threads, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      e->step_one(i, actions, obs, terminal_obs, reward, terminated, truncated,
                  episode_return, episode_length);
    }
  });
}

}  // extern "C"
