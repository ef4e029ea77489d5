"""Tutorial 10: training on your own environment.

Port of ``examples/tutorials/t10_train_custom_env.py``. A custom env is a
batched ``Env`` (``envs/base.py``): ``reset(n, generator)`` returns the
observations and state of ``n`` fresh episodes on the generator's device,
``step(state, action, generator)`` advances all of them at once, so
thousands of instances step in lockstep on the card. This defines a
goal-reaching grid env, registers it, trains PPO on the true reward, then BC
from the PPO "expert". Run:
``python -m imitation_tpu_torch.examples.tutorials.t10_train_custom_env``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from imitation_tpu_torch import Device, make_generator
from imitation_tpu_torch.algorithms.bc import BC
from imitation_tpu_torch.data import rollout
from imitation_tpu_torch.envs import make_vec_env, register
from imitation_tpu_torch.envs.base import Env, Space, TimeStep
from imitation_tpu_torch.examples.tutorials.t01_train_bc import eval_return
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig

# The moves of actions 0..3: +x, -x, +y, -y.
MOVES = ((0.1, 0.0), (-0.1, 0.0), (0.0, 0.1), (0.0, -0.1))


class GoalGrid(Env):
    """Reach the corner (1, 1); reward = -distance, 40-step horizon. The
    state is the position ``[B, 2]`` in [-1, 1], which is also the
    observation."""

    max_episode_steps = 40

    @property
    def observation_space(self) -> Space:
        return Space.box(-1.0, 1.0, (2,))

    @property
    def action_space(self) -> Space:
        return Space.discrete(4)

    def reset(self, n: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        pos = torch.rand((n, 2), generator=generator, device=generator.device) - 1.0  # U(-1, 0)
        return pos, pos

    def step(self, state: torch.Tensor, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, TimeStep]:
        delta = torch.tensor(MOVES, dtype=state.dtype, device=state.device)[action.long()]
        pos = torch.clamp(state + delta, -1.0, 1.0)
        reward = -torch.linalg.vector_norm(pos - 1.0, dim=-1)
        f = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
        return pos, TimeStep(obs=pos, reward=reward, terminated=f, truncated=f)


def main(ppo_iters: int = 30, device: Optional[Device] = None):
    try:
        register("GoalGrid-v0", GoalGrid)
    except ValueError:
        pass  # already registered (repeat run in one process)
    venv = make_vec_env("GoalGrid-v0", num_envs=16, device=device)

    policy = ActorCriticPolicy(
        observation_space=venv.observation_space, action_space=venv.action_space
    )
    ppo = PPO(venv, policy, PPOConfig(n_steps=40, n_minibatches=4, n_epochs=4,
                                      learning_rate=1e-3))
    state = ppo.init_state(make_generator(0, venv.device))
    for _ in range(ppo_iters):
        state, metrics = ppo.train_step(state)
    expert_ret = eval_return(policy, venv)
    print(f"PPO expert return on GoalGrid: {expert_ret:.2f}")

    demos = rollout.generate_trajectories(
        policy.sample_fn(), venv, rollout.make_min_episodes(20), rng=0,
    )
    bc = BC(
        observation_space=venv.observation_space,
        action_space=venv.action_space,
        demonstrations=demos,
        rng=0,
        batch_size=64,
        device=venv.device,
    )
    bc.train(n_epochs=5)
    bc_ret = eval_return(bc.policy, venv)
    print(f"BC return from 20 demos: {bc_ret:.2f}")
    return expert_ret, bc_ret


if __name__ == "__main__":
    main()
