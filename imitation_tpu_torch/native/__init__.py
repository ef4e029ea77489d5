"""The host env engine: batched classic-control envs in C++ (``envengine.cpp``),
built by ``g++`` at first use and stepped through ``ctypes``.

Port of ``imitation_tpu/native``. ``CppVectorEnv`` is a host vector env
(``is_host = True``): ``data/rollout.py`` ``HostCollector`` steps it on the
CPU while the learners update on ``venv.device``. ``envs.make_vec_env``
does not return it; it is reached through this package.
"""

from imitation_tpu_torch.native.build import load_library  # noqa: F401
from imitation_tpu_torch.native.cpp_env import ENV_TYPES, CppVectorEnv, make_cpp_vec_env  # noqa: F401
