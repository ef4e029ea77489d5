"""On-policy RL learner (PPO) and its shared infrastructure."""
