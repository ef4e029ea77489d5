"""Lockstep-batched seals MuJoCo envs on the port's own engine.

Port of ``imitation_tpu/envs/mujoco_native.py``. The JAX package steps
MuJoCo's C core through ``mujoco.rollout``; the port has neither
``mujoco`` nor ``gymnasium``, so the physics is ``native/mjtree.cpp``, a
float64 engine that computes what MuJoCo's ``mj_step`` computes (the Euler
and RK4 integrators, frictionless and pyramidal contacts, joint limits,
the inertia-box fluid model) for a tree of hinge and slide joints with
sphere and capsule geoms against planes and capsules against capsules. It reads
MuJoCo's *compiled* model from ``envs/assets/<name>.json`` (written from
``mujoco.MjModel`` by ``tests/torch_mujoco_tools.py``), so MuJoCo's
compiler is never needed.

``MujocoLockstepVectorEnv`` is a host vector env (``is_host = True``): one
``step`` crosses into C once for all B envs and ``frame_skip`` substeps;
observations and rewards are computed in numpy from the state, with the
seals semantics of the JAX env (fixed horizon, no early termination,
positions in the observation, qvel clipped where the model file says so,
the healthy reward on every step, lockstep auto-reset). Its outputs equal the
JAX env's in dtype: float64 observations, float32 rewards and returns.
The learners' collector (``data/rollout.py`` ``HostCollector``) casts the
observations to float32, as JAX does when it converts them.

``device`` is where the learners and the collected chunks live (the env
itself steps on the host): CUDA unless the caller passes ``device="cpu"``.

seals/HalfCheetah, Hopper, Walker2d and Swimmer run here; seals/Ant raises
``NotImplementedError`` (ROADMAP.md, queue A).
"""

from __future__ import annotations

import ctypes
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from imitation_tpu_torch import Device, default_device
from imitation_tpu_torch.envs.base import Space

ASSETS = Path(__file__).resolve().parent / "assets"

# env id -> model file under assets/ (None: queued, ROADMAP.md queue A)
_SPECS: Dict[str, Optional[str]] = {
    "seals/HalfCheetah-v0": "half_cheetah",
    "seals/HalfCheetah-v1": "half_cheetah",
    "seals/Hopper-v0": "hopper",
    "seals/Hopper-v1": "hopper",
    "seals/Walker2d-v0": "walker2d_v5",
    "seals/Walker2d-v1": "walker2d_v5",
    "seals/Swimmer-v0": "swimmer",
    "seals/Swimmer-v1": "swimmer",
    "seals/Ant-v0": None,
    "seals/Ant-v1": None,
}
_QUEUED = {
    "Ant": "a free joint in 3-D and cfrc_ext in the observation and reward",
}

_PLANE, _SPHERE, _CAPSULE = 0, 2, 3


def supports(env_id: str) -> bool:
    """Whether ``env_id`` is a seals MuJoCo env (ported or queued)."""
    return env_id in _SPECS


def load_model(name: str) -> dict:
    """The compiled model and env settings of ``assets/<name>.json``."""
    with open(ASSETS / f"{name}.json") as f:
        return json.load(f)


def collision_pairs(model: dict) -> np.ndarray:
    """The geom pairs MuJoCo's collision stage tests, in its order: pairs
    of distinct weld bodies that pass the contype/conaffinity test and the
    parent filter (a body and its parent do not collide unless one is the
    world), by body pair, then geom; in each pair the geom of the lower
    type first (the plane), else the lower index. [P, 2]."""
    m = model["model"]
    body, typ = m["geom_bodyid"], m["geom_type"]
    ct, ca = m["geom_contype"], m["geom_conaffinity"]
    weld, parent = m["body_weldid"], m["body_parentid"]
    pairs = []
    for g1 in range(len(body)):
        for g2 in range(g1 + 1, len(body)):
            w1, w2 = weld[body[g1]], weld[body[g2]]
            if w1 == w2 or not ((ct[g1] & ca[g2]) or (ct[g2] & ca[g1])):
                continue
            if w1 and w2 and (w1 == weld[parent[w2]] or w2 == weld[parent[w1]]):
                continue
            a, b = sorted((g1, g2), key=lambda g: typ[g])
            if (typ[a], typ[b]) not in ((_PLANE, _SPHERE), (_PLANE, _CAPSULE), (_CAPSULE, _CAPSULE)):
                raise NotImplementedError(
                    f"{model['name']}: geoms {a} and {b} (types {typ[a]}, {typ[b]}) collide; the engine "
                    "collides only spheres and capsules with planes, and capsules with capsules")
            condim = max(m["geom_condim"][a], m["geom_condim"][b])
            if condim not in (1, 3):
                raise NotImplementedError(f"{model['name']}: geoms {a} and {b} need condim {condim}; the "
                                          "engine has condim 1 and 3")
            pairs.append((tuple(sorted((w1, w2))), (a, b)))
    pairs.sort(key=lambda p: p[0])
    return np.asarray([g for _, g in pairs], np.int32).reshape(-1, 2)


def pack_model(model: dict) -> Tuple[np.ndarray, np.ndarray]:
    """The two arrays ``mjt_create`` reads (``native/mjtree.cpp``
    ``parse_model``, in that order): int32 sizes, tree, types and the
    collision pairs; float64 options and the model's values."""
    s, m, opt = model["sizes"], model["model"], model["opt"]
    if opt["integrator"] not in (0, 1) or opt["cone"] != 0:
        raise NotImplementedError(
            f"{model['name']}: the engine has the Euler and RK4 integrators and pyramidal cones")
    if any(t not in (2, 3) for t in m["jnt_type"]):
        raise NotImplementedError(f"{model['name']}: the engine has hinge and slide joints only")
    if np.any(np.asarray(m["geom_fluid"]) != 0):
        raise NotImplementedError(f"{model['name']}: the engine has the inertia-box fluid model only, "
                                  "not the ellipsoid one (geom_fluid)")
    motors = all(m[k][u] == 0 for k in ("actuator_trntype", "actuator_dyntype", "actuator_gaintype",
                                         "actuator_biastype") for u in range(s["nu"]))
    if not motors or any(g[0] != 1.0 for g in m["actuator_gainprm"]) or any(
            any(row[1:]) for row in m["actuator_gear"]):
        raise NotImplementedError(f"{model['name']}: the engine has motors on joints only")
    pairs = collision_pairs(model)
    act_dof = [m["jnt_dofadr"][j] for j, _ in m["actuator_trnid"]]
    ints = [s["nq"], s["nv"], s["nu"], s["nbody"], s["njnt"], s["ngeom"], len(pairs), opt["integrator"]]
    for k in ("body_parentid", "body_rootid", "body_jntadr", "body_jntnum", "jnt_type", "jnt_qposadr",
              "jnt_dofadr", "jnt_limited", "geom_type", "geom_bodyid", "geom_condim"):
        ints += m[k]
    ints += act_dof + m["actuator_ctrllimited"] + pairs.ravel().tolist()
    doubles = [opt["timestep"], *opt["gravity"], opt["impratio"], *opt["wind"], opt["density"], opt["viscosity"]]
    for k in ("body_pos", "body_quat", "body_mass", "body_subtreemass", "body_ipos", "body_iquat",
              "body_inertia", "body_invweight0", "jnt_pos", "jnt_axis", "jnt_stiffness", "jnt_range",
              "jnt_solref", "jnt_solimp", "jnt_margin", "qpos0", "qpos_spring", "dof_armature",
              "dof_damping", "dof_invweight0", "geom_size", "geom_pos", "geom_quat", "geom_friction",
              "geom_solref", "geom_solimp", "geom_solmix", "geom_margin", "geom_gap"):
        doubles += np.asarray(m[k], np.float64).ravel().tolist()
    doubles += [row[0] for row in m["actuator_gear"]]
    doubles += np.asarray(m["actuator_ctrlrange"], np.float64).ravel().tolist()
    return np.asarray(ints, np.int32), np.asarray(doubles, np.float64)


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


class MujocoEngine:
    """One compiled model in ``native/mjtree.cpp``: ``step`` advances a
    batch of states in place; ``inspect`` returns every stage of one
    state's forward pass (for the tests)."""

    def __init__(self, model: dict, num_threads: int = 1):
        from imitation_tpu_torch.native.build import load_mjtree

        self.model = model
        s = model["sizes"]
        self.nq, self.nv, self.nu = s["nq"], s["nv"], s["nu"]
        self._lib = load_mjtree()
        self._ints, self._doubles = pack_model(model)
        self.num_threads = num_threads
        self._handle = self._lib.mjt_create(_ptr(self._ints, ctypes.c_int), _ptr(self._doubles, ctypes.c_double),
                                            num_threads)
        if not self._handle:
            raise NotImplementedError(f"{model['name']}: a joint, geom or size the engine does not support")
        cap = np.zeros(2, np.int32)
        self._lib.mjt_capacity(self._handle, _ptr(cap, ctypes.c_int))
        self.max_contacts, self.max_rows = int(cap[0]), int(cap[1])

    def step(self, qpos: np.ndarray, qvel: np.ndarray, ctrl: np.ndarray, nstep: int) -> None:
        """Advances ``qpos`` [B, nq] and ``qvel`` [B, nv] (float64,
        C-contiguous) in place by ``nstep`` substeps under ``ctrl`` [B, nu]."""
        B = qpos.shape[0]
        for a, n in ((qpos, self.nq), (qvel, self.nv)):
            if a.dtype != np.float64 or not a.flags.c_contiguous or a.shape != (B, n):
                raise ValueError(f"expected a C-contiguous float64 [{B}, {n}] array, got {a.dtype} {a.shape}")
        ctrl = np.ascontiguousarray(ctrl, np.float64).reshape(B, self.nu)
        if self._lib.mjt_step(self._handle, B, _ptr(qpos, ctypes.c_double), _ptr(qvel, ctypes.c_double),
                              _ptr(ctrl, ctypes.c_double), int(nstep)):
            raise FloatingPointError(f"{self.model['name']}: a step failed (a matrix not positive definite)")

    def _layout(self):
        s, C, R, nv = self.model["sizes"], self.max_contacts, self.max_rows, self.nv
        nb, ng = s["nbody"], s["ngeom"]
        return (("xpos", (nb, 3)), ("xmat", (nb, 9)), ("xipos", (nb, 3)), ("geom_xpos", (ng, 3)),
                ("geom_xmat", (ng, 9)), ("subtree_com", (nb, 3)), ("cinert", (nb, 10)), ("cdof", (nv, 6)),
                ("cvel", (nb, 6)), ("qM", (nv, nv)), ("qfrc_bias", (nv,)), ("qfrc_passive", (nv,)),
                ("qfrc_actuator", (nv,)), ("qacc_smooth", (nv,)), ("contact_pos", (C, 3)),
                ("contact_frame", (C, 9)), ("contact_dist", (C,)), ("contact_geom", (C, 2)),
                ("efc_type", (R,)), ("efc_J", (R, nv)), ("efc_pos", (R,)), ("efc_margin", (R,)),
                ("efc_diagApprox", (R,)), ("efc_R", (R,)), ("efc_D", (R,)), ("efc_aref", (R,)),
                ("efc_vel", (R,)), ("efc_force", (R,)), ("qacc", (nv,)), ("qfrc_constraint", (nv,)))

    def inspect(self, qpos, qvel, ctrl) -> Dict[str, np.ndarray]:
        """MuJoCo's ``mj_forward`` of one state, by its ``MjData`` names
        (``qM`` the dense inertia; the contact and row arrays cut to
        ``ncon`` and ``nefc``)."""
        layout = self._layout()
        out = np.zeros(sum(int(np.prod(shape)) for _, shape in layout), np.float64)
        counts = np.zeros(2, np.int32)
        args = [np.ascontiguousarray(x, np.float64) for x in (qpos, qvel, ctrl)]
        if self._lib.mjt_inspect(self._handle, *(_ptr(a, ctypes.c_double) for a in args),
                                 _ptr(counts, ctypes.c_int), _ptr(out, ctypes.c_double)):
            raise FloatingPointError(f"{self.model['name']}: the forward pass failed")
        ncon, nefc = int(counts[0]), int(counts[1])
        res, at = {"ncon": ncon, "nefc": nefc}, 0
        for name, shape in layout:
            n = int(np.prod(shape))
            a = out[at:at + n].reshape(shape)
            at += n
            if name.startswith("contact_"):
                a = a[:ncon]
            elif name.startswith("efc_"):
                a = a[:nefc]
            res[name] = a.astype(np.int32) if name in ("contact_geom", "efc_type") else a
        return res

    def close(self) -> None:
        if self._handle:
            self._lib.mjt_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _space(d: dict) -> Space:
    dtype = np.dtype(d["dtype"])
    return Space(shape=tuple(d["shape"]), dtype=dtype.type, low=np.asarray(d["low"], dtype),
                 high=np.asarray(d["high"], dtype))


class MujocoLockstepVectorEnv:
    """Batched seals MuJoCo envs stepped by the port's engine: the host
    vector env contract (``reset() -> obs``, ``step(acts) -> dict``) with
    the JAX env's auto-reset and ``terminal_obs`` semantics."""

    is_host = True

    def __init__(
        self,
        env_id: str,
        num_envs: int = 8,
        max_episode_steps: Optional[int] = None,
        seed: Optional[int] = None,
        num_threads: Optional[int] = None,
        device: Optional[Device] = None,
    ):
        if env_id not in _SPECS:
            raise KeyError(f"not a seals MuJoCo env: {env_id!r}; known: {sorted(_SPECS)}")
        name = _SPECS[env_id]
        if name is None:
            family = env_id.split("/")[1].split("-")[0]
            raise NotImplementedError(
                f"{env_id} is not ported yet: it needs {_QUEUED[family]} in native/mjtree.cpp "
                "(ROADMAP.md queue A, the seals MuJoCo envs)")
        self.env_id = env_id
        self.num_envs = num_envs
        self.device = default_device(device)
        model = load_model(name)
        env = model["env"]
        self._frame_skip = int(env["frame_skip"])
        self._dt = float(model["opt"]["timestep"]) * self._frame_skip
        self._fwd_w = float(env["forward_reward_weight"])
        self._ctrl_w = float(env["ctrl_cost_weight"])
        self._noise = float(env["reset_noise_scale"])
        self._qvel_noise_normal = env["qvel_noise"] == "normal"
        self._qvel_clip = env["qvel_clip"]
        self._healthy = float(env["healthy_reward"])
        self._init_qpos = np.asarray(env["init_qpos"], np.float64)
        self._init_qvel = np.asarray(env["init_qvel"], np.float64)
        self.observation_space = _space(env["observation_space"])
        self.action_space = _space(env["action_space"])
        self.max_episode_steps = int(max_episode_steps or env["max_episode_steps"])
        if num_threads is None:
            # 16 envs or more a thread, at most 4 threads and half the cores: each step
            # call starts its threads, and on an 8-core H100 host 64 envs stepped
            # fastest on 4, HalfCheetah's Euler steps (0.76 ms a call against 1.08 on
            # 1 and 1.58 on 8) and the RK4 envs' too (Hopper 1.20-2.34 ms against
            # 2.23-3.22 on 1 and 2.08-4.55 on 8)
            num_threads = max(1, min(4, (os.cpu_count() or 2) // 2, num_envs // 16))
        self.num_threads = num_threads
        self.engine = MujocoEngine(model, num_threads)
        self._nq, self._nv = self.engine.nq, self.engine.nv
        self._qpos = np.zeros((num_envs, self._nq), np.float64)
        self._qvel = np.zeros((num_envs, self._nv), np.float64)
        self._t = 0
        self._ep_ret = np.zeros(num_envs, np.float64)
        self._rng = np.random.default_rng(seed if seed is not None else 0)

    def _obs(self) -> np.ndarray:
        qvel = self._qvel
        if self._qvel_clip is not None:
            qvel = np.clip(qvel, -self._qvel_clip, self._qvel_clip)
        return np.concatenate([self._qpos, qvel], axis=1)

    def _reset_states(self) -> None:
        B = self.num_envs
        self._qpos[:] = self._init_qpos + self._rng.uniform(-self._noise, self._noise, size=(B, self._nq))
        if self._qvel_noise_normal:
            self._qvel[:] = self._init_qvel + self._noise * self._rng.standard_normal((B, self._nv))
        else:
            self._qvel[:] = self._init_qvel + self._rng.uniform(-self._noise, self._noise, size=(B, self._nv))
        self._t = 0
        self._ep_ret[:] = 0.0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_states()
        return self._obs()

    def step(self, actions) -> dict:
        acts = np.asarray(actions, np.float64).reshape(self.num_envs, -1)
        x_before = self._qpos[:, 0].copy()
        self.engine.step(self._qpos, self._qvel, acts, self._frame_skip)
        # forward velocity minus the control cost of the unclamped actions, plus the
        # healthy reward on every step (seals' unconditional one)
        reward = (self._fwd_w * (self._qpos[:, 0] - x_before) / self._dt
                  - self._ctrl_w * np.sum(np.square(acts), axis=1)
                  + self._healthy)
        self._t += 1
        self._ep_ret += reward
        obs = self._obs()
        done = self._t >= self.max_episode_steps
        B = self.num_envs
        truncated = np.full(B, done, bool)
        ep_ret = self._ep_ret.astype(np.float32)
        ep_len = np.full(B, self._t, np.int32)
        terminal_obs = obs
        if done:
            self._reset_states()
            obs = self._obs()
        return dict(
            obs=obs,
            terminal_obs=terminal_obs,
            reward=reward.astype(np.float32),
            terminated=np.zeros(B, bool),
            truncated=truncated,
            episode_return=ep_ret,
            episode_length=ep_len,
        )

    def close(self) -> None:
        self.engine.close()
