"""Data layer: trajectory/transition types, rollout engine, replay buffer."""
