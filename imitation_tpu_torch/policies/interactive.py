"""Interactive (human-in-the-loop) policies.

Port of ``imitation_tpu/policies/interactive.py``: a console policy that
shows the current observation and asks the user for a discrete action each
step through ``input()``, with named key bindings (Atari's canonical ones, or
any supplied per env). The policies are ``NonTrainablePolicy``s: one numpy
observation at a time on the host, and through ``as_rollout_fn`` a rollout
function whose actions return to the observations' device.

One deliberate difference: ``ImageObsDiscreteInteractivePolicy._render``
prints the frame's shape, dtype and value range, where the JAX package shows
it with ``matplotlib``, which the port may not import (the GPU machine lacks
it). Override ``_render`` to show frames another way.
"""

from __future__ import annotations

import abc
import collections
from typing import Dict

import numpy as np

from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.policies.base import NonTrainablePolicy


class DiscreteInteractivePolicy(NonTrainablePolicy, abc.ABC):
    """Asks a human for discrete actions.

    ``action_keys_names`` maps key -> human-readable action name, in action
    index order.
    """

    def __init__(
        self,
        observation_space: Space,
        action_space: Space,
        action_keys_names: "collections.OrderedDict[str, str]",
        clear_screen_on_query: bool = True,
    ):
        super().__init__(observation_space, action_space)
        if not action_space.is_discrete:
            raise ValueError("DiscreteInteractivePolicy requires a discrete space")
        if len(action_keys_names) != action_space.n:
            raise ValueError(
                f"need one key per action: {len(action_keys_names)} != {action_space.n}"
            )
        if len(set(action_keys_names.keys())) != len(action_keys_names):
            raise ValueError("duplicate action keys")
        self.action_keys_names = action_keys_names
        self.action_key_to_index = {k: i for i, k in enumerate(action_keys_names.keys())}
        self.clear_screen_on_query = clear_screen_on_query

    def _choose_action(self, obs: np.ndarray) -> np.ndarray:
        if self.clear_screen_on_query:
            print("\033c", end="")
        self._render(obs)
        context = ", ".join(f"{key}: {name}" for key, name in self.action_keys_names.items())
        while True:
            print(f"Please select an action. Possible choices in [{context}]")
            key = input("Your choice (enter key): ").strip()
            if key in self.action_key_to_index:
                return np.asarray(self.action_key_to_index[key])
            print(f"Invalid key: {key!r}")

    @abc.abstractmethod
    def _render(self, obs: np.ndarray) -> None:
        ...


class TextInteractivePolicy(DiscreteInteractivePolicy):
    """Prints the observation as text (console envs)."""

    def _render(self, obs: np.ndarray) -> None:
        print(f"Observation: {np.asarray(obs)}")


class ImageObsDiscreteInteractivePolicy(DiscreteInteractivePolicy):
    """For image observations: prints the frame's shape, dtype and value
    range (the JAX package draws it with matplotlib)."""

    def _render(self, obs: np.ndarray) -> None:
        img = self._prepare_obs_image(obs)
        lo, hi = (img.min(), img.max()) if img.size else (None, None)
        print(f"Observation: image {img.shape} {img.dtype}, values in [{lo}, {hi}]")

    def _prepare_obs_image(self, obs: np.ndarray) -> np.ndarray:
        """Hook for cropping or processing the frame."""
        return np.asarray(obs)


# Canonical key bindings for the full Atari action set: directions on a
# wasd-style rose, FIRE variants on the surrounding keys.
ATARI_ACTION_NAMES_TO_KEYS: Dict[str, str] = {
    "NOOP": "1",
    "FIRE": "2",
    "UP": "w",
    "RIGHT": "d",
    "LEFT": "a",
    "DOWN": "x",
    "UPRIGHT": "e",
    "UPLEFT": "q",
    "DOWNRIGHT": "c",
    "DOWNLEFT": "z",
    "UPFIRE": "t",
    "RIGHTFIRE": "h",
    "LEFTFIRE": "f",
    "DOWNFIRE": "b",
    "UPRIGHTFIRE": "y",
    "UPLEFTFIRE": "r",
    "DOWNRIGHTFIRE": "n",
    "DOWNLEFTFIRE": "v",
}


class AtariInteractivePolicy(ImageObsDiscreteInteractivePolicy):
    """Interactive policy for Atari-style image envs.

    ``action_names`` is the env's action-meaning list in action-index order
    (``env.get_action_meanings()``). Each name is bound to its canonical key
    from ``ATARI_ACTION_NAMES_TO_KEYS``, so Pong's 6-action subset gets the
    same keys as Breakout's 4-action subset.
    """

    def __init__(
        self,
        observation_space: Space,
        action_space: Space,
        action_names: "collections.abc.Sequence[str]",
        **kwargs,
    ):
        unknown = [n for n in action_names if n not in ATARI_ACTION_NAMES_TO_KEYS]
        if unknown:
            raise ValueError(
                f"unknown Atari action name(s) {unknown}; expected a subset "
                f"of {sorted(ATARI_ACTION_NAMES_TO_KEYS)}"
            )
        action_keys_names = collections.OrderedDict(
            (ATARI_ACTION_NAMES_TO_KEYS[name], name) for name in action_names
        )
        super().__init__(observation_space, action_space, action_keys_names, **kwargs)


def atari_interactive_policy(venv, **kwargs) -> AtariInteractivePolicy:
    """An ``AtariInteractivePolicy`` for ``venv``, from the action meanings
    of ``venv`` (or of its ``env``, unwrapped)."""
    base = getattr(venv, "env", venv)
    base = getattr(base, "unwrapped", base)
    if not hasattr(base, "get_action_meanings"):
        raise ValueError(
            "env does not expose get_action_meanings(); pass action_names to "
            "AtariInteractivePolicy directly"
        )
    return AtariInteractivePolicy(
        venv.observation_space, venv.action_space, base.get_action_meanings(), **kwargs
    )


def cartpole_interactive_policy(space_obs: Space, space_act: Space):
    """Example construction with named bindings."""
    return TextInteractivePolicy(
        space_obs,
        space_act,
        collections.OrderedDict([("a", "push left"), ("d", "push right")]),
    )
